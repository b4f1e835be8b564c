"""encode_kernels_roofline: the least time of the traced compress calls
(their input read once and their payload written once, at the card's
memory bandwidth: benchmark/roofline.py) as a percentage of the summed
device time of every kernel traced inside those calls."""

from benchmark import roofline, trace


def read(run):
    t, w = run.trace, run.window
    if t is None or w is None or not w.in_bytes:
        return None
    kernel_s = trace.kernel_us_in(t.device, t.of("encode")) / 1e6
    n = sum(roofline.encode_bytes(a, b)
            for a, b in zip(w.in_bytes, w.payload_bytes))
    return roofline.share_pct(n, kernel_s)
