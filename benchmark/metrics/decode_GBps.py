"""decode_GBps: the output bytes of every decompress call in the window
over the sum of those calls' seconds, in 1e9 bytes a second."""


def read(run):
    w = run.window
    if w is None or run.trace is not None or not w.dec_s:
        return None
    return sum(w.out_bytes) / sum(w.dec_s) / 1e9
