"""The container writer against the JAX package's writer.

`container.build_container` writes the table section and the unit index
through the host library (`utils/container_writer.cpp`), which sizes
every form and writes only the chosen one. It must give the JAX
package's bytes, which write every form in full (tolerance 0), over the
forms' edges: unit counts from none to 12,800, equal lengths, residuals
past one byte, ties between index forms and between the raw and packed
tables, one or all contexts present, one nibble value. An index the
format cannot hold raises as the JAX package's writer does.
"""

import numpy as np
import pytest

from mhc_tpu import container as jax_container
from mhc_tpu_torch import container
from mhc_tpu_torch.utils import native

BLOCK = 65536
MARKOV, ORDER0 = container.MODE_MARKOV, container.MODE_ORDER0
DU = {MARKOV: 8192, ORDER0: 16384}


def _lengths(mode, rng, present=256):
    """Huffman code lengths from random counts, `present` contexts."""
    rows = 256 if mode == MARKOV else 1
    counts = rng.integers(0, 400, (rows, 256)).astype(np.int32)
    counts[rng.random((rows, 256)) < 0.4] = 0
    counts[:, 0] += 1
    if mode == MARKOV:
        counts[rng.permutation(256)[present:]] = 0
    lens = native.code_lengths(counts, 15)
    return lens if mode == MARKOV else lens[0]


def _units(idx_lens, mode=MARKOV, rng=None, **kw):
    """A sub-stream case whose unit index holds `idx_lens`."""
    rng = rng or np.random.default_rng(len(idx_lens))
    idx_lens = np.asarray(idx_lens, np.int64)
    per = 32 if container.aligned_payload(mode) else 8
    if "lengths" not in kw:
        kw["lengths"] = _lengths(mode, rng)
    return dict(mode=mode, orig_len=len(idx_lens) * DU[mode],
                bits=idx_lens * per - rng.integers(0, per, len(idx_lens)),
                decode_unit=DU[mode], **kw)


def _clustered(n, mode=MARKOV, seed=0):
    rng = np.random.default_rng(seed)
    return _units(200 + rng.integers(0, 60, n), mode, rng)


def _one_context_row(row):
    lens = np.zeros((256, 256), np.uint8)
    lens[77] = row
    return lens


def _wide(n=12_800):
    """Residuals 0 or 300 at random: both of the entropy index's streams
    cost a bit a unit, every bit-packed form nine."""
    rng = np.random.default_rng(5)
    return _units(100 + 300 * rng.integers(0, 2, n), rng=rng,
                  want=container.FLAG_ENTROPY_INDEX, high_stream=True)


def _legacy(mode, n_blocks=5):
    rng = np.random.default_rng(9)
    return dict(mode=mode, orig_len=n_blocks * BLOCK - 123,
                bits=rng.integers(1000, 400_000, n_blocks),
                decode_unit=None, lengths=_lengths(mode, rng))


GROUPED = container.FLAG_GROUPED_INDEX
CASES = {
    "markov_legacy": lambda: _legacy(MARKOV),
    "order0_legacy": lambda: _legacy(ORDER0),
    "markov_units_0": lambda: _units([], want=0),
    "order0_units_0": lambda: _units([], ORDER0, want=0),
    **{f"markov_units_{n}": (lambda n=n: _clustered(n))
       for n in (1, 127, 128, 129, 12_800)},
    **{f"order0_units_{n}": (lambda n=n: _clustered(n, ORDER0, seed=n))
       for n in (1, 129, 12_800)},
    # nbits 0: the flat index's 3 bytes
    "equal_lengths": lambda: _units(np.full(300, 123), want=0),
    "residuals_past_255": _wide,
    # the flat index and the grouped one at 32 units both take 18 bytes
    "tie_flat_grouped32": lambda: _units(
        np.r_[100 + np.arange(32) % 4, np.full(28, 100)], want=0),
    # the grouped index at 32 and at 64 units both take 40 bytes
    "tie_grouped32_grouped64": lambda: _units(
        100 + np.where(np.arange(225) < 8, np.arange(225) % 5, 0),
        want=GROUPED, group=32),
    # one context of 13 nibble values, 958 bits coded: packed tables of
    # 40 + 120 bytes, as long as the raw 32 + 128, so raw. No prefix code
    # spreads its lengths so evenly (a parse refuses these), but the
    # writers take lengths as they come
    "tables_tie": lambda: _units(
        np.full(8, 50), lengths=_one_context_row(
            np.repeat(np.arange(13), [28] + [19] * 12)), packed=False),
    "one_context": lambda: _units(
        np.full(4, 60), lengths=_lengths(MARKOV, np.random.default_rng(2),
                                         present=1)),
    # every length 8: one nibble value, a bit a symbol
    "one_nibble_value": lambda: _units(
        np.full(4, 60), lengths=np.full((256, 256), 8, np.uint8),
        packed=True),
    "all_contexts": lambda: _clustered(129, seed=3),
}


def _build(case, crc):
    rng = np.random.default_rng(11)
    size = int(container.stream_byte_lens(case["bits"], case["mode"]).sum())
    payload = rng.integers(0, 256, size, np.uint8).tobytes()
    args = (case["mode"], case["orig_len"], BLOCK, case["lengths"],
            case["bits"], payload, crc)
    return args, dict(decode_unit=case["decode_unit"])


@pytest.mark.parametrize("crc", [None, 0x89ABCDEF])
@pytest.mark.parametrize("name", list(CASES))
def test_writers_match_jax(name, crc):
    case = CASES[name]()
    args, kw = _build(case, crc)
    ref = jax_container.build_container(*args, **kw)
    assert container.build_container(*args, **kw) == ref
    # the case reaches the form it names
    flags = ref[6]
    if "want" in case:
        assert flags & (container.FLAG_ENTROPY_INDEX | GROUPED) \
            == case["want"]
    if "group" in case or "high_stream" in case:
        meta = container.parse_container(ref)
        index = ref[meta.payload_off - meta.index_bytes:]
    if "group" in case:
        assert int.from_bytes(index[:4], "little") == case["group"]
    if "high_stream" in case:
        assert index[2] == 1   # the entropy index's high-bytes flag
    if "packed" in case:
        assert bool(flags & container.FLAG_PACKED_TABLES) == case["packed"]


def test_writer_falls_back_where_the_format_cannot_hold_a_length():
    case = _units(np.r_[70_000, np.full(40, 70_100)])
    args, kw = _build(case, None)
    with pytest.raises(Exception) as got:
        container.build_container(*args, **kw)
    with pytest.raises(type(got.value)):
        jax_container.build_container(*args, **kw)
    with pytest.raises(type(got.value)):
        native.write_index(np.r_[70_000, 70_001], container.INDEX_GROUPS)
