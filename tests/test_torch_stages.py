"""The plain versions of the engine's stage kernels (K13 canonical tables,
K10+K8 literal substitution + compaction, K9/K12 expansion, K14 literal
rows) against the JAX package's XLA stages on the same seeded inputs,
tolerance 0: ragged last units, n_valid 0 rows, bits 0, units at the
literal boundary, both layouts. The CUDA kernels are held to these plain
versions in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mhc_tpu import api as jax_api
from mhc_tpu.ops import bitpack as jax_bitpack
from mhc_tpu.ops import canonical as jax_canonical
import mhc_tpu_torch
from mhc_tpu_torch import engine
from mhc_tpu_torch.models.entropy import MARKOV, ORDER0
from mhc_tpu_torch.ops import bitpack, canonical
from mhc_tpu_torch.ops.kernels import stages_cuda, tables_cuda
from tests.corpus import english_like

DU = 64                                  # bytes a unit
W_PACK = bitpack.words_for_block(DU)     # K3's row width: 32 words


def _units(seed: int):
    """(R, DU) uint8 units, zero past n_valid, and (R,) int32 n_valid:
    full units, n_valid 0 rows, and a ragged last unit."""
    rng = np.random.default_rng(seed)
    nv = np.full(12, DU, np.int32)
    nv[[3, 7]] = 0
    nv[-1] = 37
    u = rng.integers(0, 256, (12, DU), dtype=np.uint8)
    u[np.arange(DU)[None, :] >= nv[:, None]] = 0
    return u, nv


def _bits(nv: np.ndarray, aligned: bool, seed: int) -> np.ndarray:
    """Bit counts that put units on both sides of the literal boundary
    (aligned: ceil(bits / 32) against ceil(nv / 4); unaligned: ceil(bits
    / 8) against nv), and 0."""
    rng = np.random.default_rng(seed)
    unit = 32 if aligned else 8
    need = -(-nv.astype(np.int64) * 8 // unit)     # layout units of a literal
    at = need * unit - rng.integers(0, unit, len(nv))          # literal
    below = (need - 1) * unit - rng.integers(0, unit, len(nv))  # coded
    bits = np.where(np.arange(len(nv)) % 2, at, below)
    bits[[0, 5]] = 0
    return np.maximum(bits, 0).astype(np.int32)


@pytest.mark.parametrize("aligned", [True, False])
def test_compact_units_plain_equals_substitution_and_compaction(aligned):
    u, nv = _units(1)
    bits = _bits(nv, aligned, 2)
    words = np.random.default_rng(3).integers(
        0, 1 << 32, (len(nv), W_PACK), dtype=np.uint64).astype(np.uint32)
    rw, rb = jax_bitpack.substitute_raw_units(
        jnp.asarray(words), jnp.asarray(bits), jnp.asarray(u),
        jnp.asarray(nv), aligned)
    wl = (np.asarray(rb).astype(np.int64) + 31) // 32
    offs = np.concatenate([[0], np.cumsum(wl)]).astype(np.int32)
    ref = np.asarray(jax_bitpack.device_compact_words(
        rw, jnp.asarray(offs), int(offs[-1])))

    raw = bitpack.literal_unit_mask(bits, nv, aligned)
    assert raw.any() and not raw.all()
    bit_lens = np.where(raw, nv.astype(np.int64) * 8, bits)
    np.testing.assert_array_equal(bit_lens, np.asarray(rb))
    got = bitpack.compact_units_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(u),
        torch.from_numpy(nv), torch.from_numpy(offs.astype(np.int64)),
        torch.from_numpy(raw), int(offs[-1]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_expand_units_plain_equals_word_expansion():
    rng = np.random.default_rng(4)
    lens = rng.integers(0, 9, 10).astype(np.int64)
    lens[[2, 6]] = 0
    offs = np.concatenate([[0], np.cumsum(lens)])
    payload = rng.integers(0, 1 << 32, int(offs[-1]),
                           dtype=np.uint64).astype(np.uint32)
    W = int(lens.max()) + 1
    ref = np.asarray(jax_bitpack.device_expand_words_u32(
        jnp.asarray(payload), jnp.asarray(offs[:-1].astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), W))
    got = bitpack.expand_units_plain(torch.from_numpy(payload.view(np.int32)),
                                     torch.from_numpy(offs), W)
    assert got.dtype == torch.int32 and got.shape == (10, W)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_expand_units_plain_equals_byte_expansion():
    """K12: byte offsets that are not multiples of 4, lengths that end
    inside a word, empty units."""
    rng = np.random.default_rng(5)
    lens = rng.integers(0, 23, 10).astype(np.int64)
    lens[[1, 4]] = 0
    lens[0] = 5
    offs = np.concatenate([[0], np.cumsum(lens)])
    assert (offs[:-1] % 4 != 0).any()
    payload = rng.integers(0, 256, int(offs[-1]), dtype=np.uint8)
    W = int(-(-lens.max() // 4)) + 1
    ref = np.asarray(jax_bitpack.device_expand_words(
        jnp.asarray(payload), jnp.asarray(offs[:-1].astype(np.int32)),
        jnp.asarray(lens.astype(np.int32)), W))
    got = bitpack.expand_units_plain(torch.from_numpy(payload),
                                     torch.from_numpy(offs), W)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


@pytest.mark.parametrize("W", [W_PACK, DU // 4 - 5])
def test_literal_rows_plain_equals_unit_bytes_and_where(W):
    """K14, with rows as wide as K3's and narrower than a literal (only a
    ragged last unit literal: the rest of the row reads as zeros)."""
    rng = np.random.default_rng(W)
    words = rng.integers(0, 1 << 32, (9, W),
                         dtype=np.uint64).astype(np.uint32)
    out = rng.integers(0, 256, (9, DU), dtype=np.uint8)
    raw = np.zeros(9, bool)
    raw[[0, 4, 8]] = True
    ref = np.asarray(jnp.where(
        jnp.asarray(raw)[:, None],
        jax_bitpack.words_to_unit_bytes(jnp.asarray(words), DU),
        jnp.asarray(out)))
    got = torch.from_numpy(out.copy())
    back = bitpack.literal_rows_plain(
        got, torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(np.flatnonzero(raw)))
    assert back is got
    np.testing.assert_array_equal(got.numpy(), ref)


def _lengths(markov: bool, seed: int) -> np.ndarray:
    """Code lengths of seeded zipf counts; for Markov row 0 all absent,
    row 1 one symbol, row 2 two symbols."""
    rng = np.random.default_rng(seed)
    shape = (256, 256) if markov else (256,)
    counts = rng.zipf(1.3, shape) * (rng.random(shape) < 0.6)
    if markov:
        counts[0] = 0
        counts[1] = 0
        counts[1, 77] = 5
        counts[2] = 0
        counts[2, [3, 200]] = 9
    model = MARKOV if markov else ORDER0
    return model.lengths_from_counts(np.minimum(counts, 1 << 30))


def _one_symbol() -> np.ndarray:
    x = np.zeros(256, np.uint8)
    x[200] = 1
    return x


@pytest.mark.parametrize("case", ["markov", "order0", "order0_absent",
                                  "order0_one_symbol"])
def test_canonical_tables_plain_equals_canonical_codes(case):
    lengths = {"markov": lambda: _lengths(True, 6),
               "order0": lambda: _lengths(False, 7),
               "order0_absent": lambda: np.zeros(256, np.uint8),
               "order0_one_symbol": _one_symbol}[case]()
    ref = jax_canonical.canonical_codes(jnp.asarray(lengths, jnp.int32))
    got = canonical.canonical_tables_plain(
        torch.from_numpy(lengths.reshape(-1, 256)), 256)
    assert set(got) == set(ref)
    for k, v in got.items():
        r = np.asarray(ref[k]).astype(np.int64)
        assert v.dtype == torch.int32 and v.is_contiguous(), k
        assert v.shape == (256, r.shape[-1]), k
        np.testing.assert_array_equal(v.numpy(),
                                      np.broadcast_to(r, v.shape), err_msg=k)


def test_cpu_wrappers_take_the_plain_versions(monkeypatch):
    """On CPU tensors each wrapper returns its plain version's result,
    and only because the tensors lie on the CPU."""
    calls = []
    for mod, name in ((bitpack, "compact_units_plain"),
                      (bitpack, "expand_units_plain"),
                      (bitpack, "literal_rows_plain"),
                      (canonical, "canonical_tables_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    u, nv = _units(8)
    words = torch.zeros((12, W_PACK), dtype=torch.int32)
    offs = torch.arange(13, dtype=torch.int64)
    lit = torch.zeros(12, dtype=torch.bool)
    pay = stages_cuda.compact_units(words, torch.from_numpy(u),
                                    torch.from_numpy(nv), offs, lit, 12)
    rows = stages_cuda.expand_units(pay, offs, 2)
    out = torch.zeros((12, DU), dtype=torch.uint8)
    stages_cuda.literal_rows(out, rows, torch.tensor([1]))
    tables_cuda.canonical_tables(torch.ones((1, 256), dtype=torch.uint8),
                                 256)
    assert calls == ["compact_units_plain", "expand_units_plain",
                     "literal_rows_plain", "canonical_tables_plain"]


@pytest.mark.parametrize("call", ["compact_dtype", "compact_width",
                                  "compact_offsets", "expand_dtype",
                                  "expand_offsets", "literal_du",
                                  "literal_rows_dtype", "tables_dtype",
                                  "tables_rows", "tables_view"])
def test_wrappers_refuse_what_their_kernels_do_not_take(call):
    u = torch.zeros((4, 8), dtype=torch.uint8)
    nv = torch.full((4,), 8, dtype=torch.int32)
    w = torch.zeros((4, 3), dtype=torch.int32)
    offs = torch.zeros(5, dtype=torch.int64)
    lit = torch.zeros(4, dtype=torch.bool)
    lengths = torch.ones((2, 256), dtype=torch.uint8)
    fn = {
        "compact_dtype": lambda: stages_cuda.compact_units(
            w.long(), u, nv, offs, lit, 0),
        "compact_width": lambda: stages_cuda.compact_units(
            w[:, :1], u, nv, offs, lit, 0),
        "compact_offsets": lambda: stages_cuda.compact_units(
            w, u, nv, offs[:4], lit, 0),
        "expand_dtype": lambda: stages_cuda.expand_units(
            w.reshape(-1).long(), offs, 2),
        "expand_offsets": lambda: stages_cuda.expand_units(
            w.reshape(-1), offs.int(), 2),
        "literal_du": lambda: stages_cuda.literal_rows(
            u[:, :6].contiguous(), w, torch.tensor([0])),
        "literal_rows_dtype": lambda: stages_cuda.literal_rows(
            u, w, torch.tensor([0], dtype=torch.int32)),
        "tables_dtype": lambda: tables_cuda.canonical_tables(
            lengths.long(), 2),
        "tables_rows": lambda: tables_cuda.canonical_tables(lengths, 256),
        "tables_view": lambda: tables_cuda.canonical_tables(
            torch.ones((256, 2), dtype=torch.uint8).t(), 2),
    }[call]
    with pytest.raises(ValueError):
        fn()


def test_upload_keeps_each_array():
    arrays = (np.arange(5, dtype=np.int64), np.array([-1, 2, 3], np.int32),
              np.array([True, False, True]), np.zeros(0, np.int64))
    got = engine.upload("cpu", *arrays)
    for a, t in zip(arrays, got):
        want = a.view(np.uint8) if a.dtype == bool else a
        assert t.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_slice_writes_and_reads_the_reference_container(mode):
    """The engine on the plain versions, literal units in play: the JAX
    package's container, and its container decoded (order-0: the
    unaligned layout, K12's)."""
    rng = np.random.default_rng(9)
    data = (english_like(20_000, seed=9)
            + rng.integers(0, 256, 9_000, dtype=np.uint8).tobytes()
            + english_like(4_321, seed=10))
    blob = jax_api.compress(data, mode=mode, decode_unit=1024)
    assert mhc_tpu_torch.compress(data, mode=mode, decode_unit=1024,
                                  device="cpu") == blob
    assert mhc_tpu_torch.decompress(blob, device="cpu") == data


def test_units_coded_at_8_bits_are_all_literal():
    """Markov lengths of 8 for every pair code each unit in exactly its
    own bytes, so every unit is literal (ceil(bits / 32) == ceil(n_valid
    / 4)): the payload is the input's bytes, unit by unit, and decode
    writes every row from them (K14's plain version)."""
    data = english_like(5_000, seed=11)
    st = engine.stage(data, decode_unit=1024, device="cpu")
    enc = engine.encode(st, lengths=np.full((256, 256), 8, np.uint8))
    np.testing.assert_array_equal(enc.bit_lens, 8 * engine.host_n_valid(
        len(data), 1024, st.n_units))
    assert engine.fetch_payload(enc) == data + bytes(-len(data) % 4)
    words, n_dec, raw, _ = engine.decode_inputs(enc)
    assert raw.all() and not n_dec.any()
    assert engine.fetch_bytes(enc, engine.decode(enc)) == data
