"""benchmark/inputs.py: deterministic per seed, distinct per stream, and
the four part kinds of the mixed corpus in their shares."""

import numpy as np
import pytest

from benchmark import inputs

SEEDS = (0, 2**31 + 12345, 2**40 + 7)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_bytes(seed):
    a = inputs.corpus(1 << 20, seed)
    b = inputs.corpus(1 << 20, seed)
    assert a.dtype == np.uint8 and a.size == 1 << 20
    assert np.array_equal(a, b)


def test_seeds_and_streams_differ():
    a = inputs.corpus(1 << 20, 5)
    assert not np.array_equal(a, inputs.corpus(1 << 20, 6))
    pool = inputs.pool(3, 1 << 18, 5)
    assert len({p.tobytes() for p in pool}) == 3
    assert np.array_equal(pool[0], inputs.corpus(1 << 18, 5, stream=0))


def _parts(data, kinds):
    """Split a corpus into its parts: every part is 65,536 bytes but a
    text part, which runs to the end of its last token."""
    out, off = [], 0
    for k in kinds:
        if k != "text":
            out.append((k, data[off: off + inputs.PART_BYTES]))
            off += inputs.PART_BYTES
            continue
        # a text part ends at the first token boundary at or past 65,536
        rest = data[off:].tobytes()
        end = inputs.PART_BYTES
        while end < len(rest) and rest[end - 1: end] not in (b" ", b"\n"):
            end += 1
        out.append((k, data[off: off + end]))
        off += end
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_four_part_kinds(seed):
    n = 16 * inputs.PART_BYTES
    data = inputs.corpus(n, seed)
    kinds = inputs.part_kinds(n, seed)
    assert sorted(kinds) == sorted(inputs.KINDS * 4)
    vocab = set(b"".join(inputs.WORDS) + b" .\n")
    for kind, part in _parts(data, kinds):
        if part.size < inputs.PART_BYTES:
            break   # the corpus's cut end
        if kind == "text":
            assert set(part.tobytes()) <= vocab
            assert part.size >= inputs.PART_BYTES
        elif kind == "counters":
            c = part.view("<u4").astype(np.int64)
            assert np.array_equal(np.diff(c), np.ones(c.size - 1))
            assert c[0] < 1 << 24
        elif kind == "repeat":
            assert np.array_equal(part, np.tile(part[:64], 1024))
        else:
            assert np.unique(part).size > 250


def test_kind_shares_follow_the_weights():
    assert inputs.kind_counts(1600, {k: 0.25 for k in inputs.KINDS}) == \
        {k: 400 for k in inputs.KINDS}
    c = inputs.kind_counts(10, {"text": 0.5, "noise": 0.5})
    assert c == {"text": 5, "counters": 0, "repeat": 0, "noise": 5}
    with pytest.raises(ValueError):
        inputs.kind_counts(10, {"text": 0.5})
    data = inputs.corpus(8 * inputs.PART_BYTES, 3, {"noise": 1.0})
    assert np.unique(data).size == 256
