"""engine_held_per_byte.decode: per decode call of the entry's held-memory
pass, the most device memory the call held beyond what was held at its
entry (the staged object and the encode's result), over the object's
bytes; the mean over the calls, in bytes a byte. None where the pass
gave no reading."""

from benchmark import harness

_held = harness.load_metric("engine_held_per_byte.encode")


def read(run):
    return _held.held_per_byte(run, "decode")
