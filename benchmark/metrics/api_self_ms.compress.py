"""api_self_ms.compress: per traced compress call, the ms of the
host-bytes API's own host work: the union of the program's
`mhc.api.compress` spans inside the call, less the union of the
`mhc.engine.*`, `mhc.launch.*` and `mhc.wait.*` spans inside them
(blockify, the staging copies' start, crc32, the table build's host
side, the payload's cut and join, the container)."""

from benchmark import harness

_spans = harness.load_metric("engine_self_ms.encode")


def read(run):
    return _spans.ms_per_call(run, "encode", "mhc.api.compress",
                              ("mhc.engine.",) + _spans.LAUNCH_AND_WAIT)
