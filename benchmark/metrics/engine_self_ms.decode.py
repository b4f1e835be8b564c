"""engine_self_ms.decode: per traced decompress call, the ms of the
engine's own host work: the union of the `mhc.engine.decode` spans
inside the call, less the union of the `mhc.launch.*` and `mhc.wait.*`
spans inside those: the decode's host plan (`_decode_inputs`' checks,
lengths and literal mask, the upload's buffer)."""

from benchmark import harness

_spans = harness.load_metric("engine_self_ms.encode")


def read(run):
    return _spans.ms_per_call(run, "decode", "mhc.engine.decode",
                              _spans.LAUNCH_AND_WAIT)
