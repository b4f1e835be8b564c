"""engine_self_ms.encode: per traced compress call, the ms of the
engine's own host work: the union of the program's `mhc.engine.encode`
spans inside the call, less the union of the `mhc.launch.*` and
`mhc.wait.*` spans inside those (the kernels' launches and the waits for
the device), which leaves the engine's host plan. None where the trace
holds no such span (a program without them).

`ms_per_call` is the arithmetic of every reader of the program's spans;
the other five load it from here."""

from benchmark import trace

LAUNCH_AND_WAIT = ("mhc.launch.", "mhc.wait.")


def _merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def ms_per_call(run, role: str, outer, inner=()):
    """Per call of direction `role` (the harness's span), the ms of the
    union of the host spans whose names start with `outer`, clipped to
    the call, less the union of those named by `inner` clipped to them;
    the mean over the calls. None without a trace, a call, or a span
    named by `outer`."""
    t = run.trace
    calls = t.of(role) if t is not None else []
    tops = [op for op in t.host_ops if op[2].startswith(outer)] \
        if calls else []
    if not tops:
        return None
    inside = [op for op in t.host_ops if op[2].startswith(inner)] \
        if inner else []
    us = 0.0
    for call in calls:
        own = _merged(trace._clip(tops, call))
        us += trace.union_us(own) - trace.busy_in(inside, own)
    return us / len(calls) / 1e3


def read(run):
    return ms_per_call(run, "encode", "mhc.engine.encode", LAUNCH_AND_WAIT)
