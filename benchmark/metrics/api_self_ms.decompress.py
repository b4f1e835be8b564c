"""api_self_ms.decompress: per traced decompress call, the ms of the
host-bytes API's own host work: the union of the `mhc.api.decompress`
spans inside the call, less the union of the `mhc.engine.*`,
`mhc.launch.*` and `mhc.wait.*` spans inside them (the container's parse
and checks, the staging fill, the output's join, crc32)."""

from benchmark import harness

_spans = harness.load_metric("engine_self_ms.encode")


def read(run):
    return _spans.ms_per_call(run, "decode", "mhc.api.decompress",
                              ("mhc.engine.",) + _spans.LAUNCH_AND_WAIT)
