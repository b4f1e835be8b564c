"""launch_host_ms.decode: per traced decompress call, the ms of the
union of the program's `mhc.launch.*` spans inside the call."""

from benchmark import harness

_spans = harness.load_metric("engine_self_ms.encode")


def read(run):
    return _spans.ms_per_call(run, "decode", "mhc.launch.")
