"""device_idle_share.decode: one minus the device's busy time (the union
of the traced CUDA intervals, kernels and copies) inside the decompress
calls' spans, over those spans' wall time."""

from benchmark import trace


def read(run):
    t = run.trace
    spans = t.of("decode") if t is not None else []
    wall = sum(e - s for s, e in spans)
    if wall <= 0 or not t.device:
        return None
    return 1.0 - trace.busy_in(t.device, spans) / wall
