"""decode_kernels_roofline: the least time of the traced decompress calls
(their payload read once and their output written once, at the card's
memory bandwidth: benchmark/roofline.py) as a percentage of the summed
device time of every kernel traced inside those calls."""

from benchmark import roofline, trace


def read(run):
    t, w = run.trace, run.window
    if t is None or w is None or not w.out_bytes:
        return None
    kernel_s = trace.kernel_us_in(t.device, t.of("decode")) / 1e6
    n = sum(roofline.decode_bytes(a, b)
            for a, b in zip(w.payload_bytes, w.out_bytes))
    return roofline.share_pct(n, kernel_s)
