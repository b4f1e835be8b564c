"""encode_GBps: the input bytes of every compress call in the window over
the sum of those calls' seconds (each timed from entry to return, its
result synchronised), in 1e9 bytes a second."""


def read(run):
    w = run.window
    if w is None or run.trace is not None or not w.enc_s:
        return None
    return sum(w.in_bytes) / sum(w.enc_s) / 1e9
