"""launch_host_ms.encode: per traced compress call, the ms of the union
of the program's `mhc.launch.*` spans inside the call: the host's cost to
put kernels on the card (each wrapper's checks past the device test, its
output allocations and zero fills, the C call)."""

from benchmark import harness

_spans = harness.load_metric("engine_self_ms.encode")


def read(run):
    return _spans.ms_per_call(run, "encode", "mhc.launch.")
