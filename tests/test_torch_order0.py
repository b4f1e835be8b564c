"""Order-0 parity: mhc_tpu_torch's order-0 mode against the JAX package.

Each stage on the CPU (the kernels' plain versions) equals its JAX
counterpart with tolerance 0: K2's counts, the broadcast order-0 tables,
K7o's decode, K12's byte-granular expansion, and the containers, which
are byte-identical and decode in both packages, literal units included.
Also: `device=None` never falls back to the CPU.
"""

import zlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import mhc_tpu_torch
from bench import make_corpus
from mhc_tpu import api as jax_api
from mhc_tpu.models.entropy import ORDER0 as JAX_ORDER0
from mhc_tpu.ops import bitpack as jax_bitpack
from mhc_tpu.ops import canonical, histogram
from mhc_tpu.ops.kernels import decode_pallas, histogram_pallas
from mhc_tpu_torch import config, container, engine
from mhc_tpu_torch.models.entropy import ORDER0, tables_from_numpy
from mhc_tpu_torch.ops import bitpack
from mhc_tpu_torch.ops import histogram as port_histogram
from mhc_tpu_torch.ops.kernels import decode_cuda, histogram_cuda
from tests.corpus import ADVERSARIAL, english_like, mixed_binary

CORPORA = dict(ADVERSARIAL)
CORPORA["english_200k"] = english_like(200_000)
CORPORA["mixed_300k"] = mixed_binary(300_000)
# 1 MB of the main-path corpus: 27 of its 64 order-0 units are literal
CORPORA["bench_1m"] = make_corpus(1 << 20)


def _ragged(B: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    units = rng.integers(0, 256, (B, n), dtype=np.uint8)
    units[units < 200] %= 29
    nv = rng.integers(1, n + 1, B).astype(np.int32)
    nv[0] = n
    nv[1] = 0
    return units, nv


@pytest.mark.parametrize("B,n,seed", [(8, 64, 1), (10, 4096, 2)])
def test_order0_histogram_matches_jax_scatter(B, n, seed):
    units, nv = _ragged(B, n, seed)
    ref = np.asarray(histogram.histogram_order0(
        jnp.asarray(units), jnp.asarray(nv), method="scatter"))
    got = port_histogram.histogram_order0(torch.from_numpy(units),
                                          torch.from_numpy(nv))
    assert got.dtype == torch.int64 and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        ORDER0.histogram(torch.from_numpy(units), torch.from_numpy(nv)),
        ref)


def test_order0_histogram_matches_pallas_interpret():
    units, nv = _ragged(8, 64, 3)
    ref = np.asarray(histogram_pallas.order0_hist_pallas(
        jnp.asarray(units), jnp.asarray(nv), interpret=True))
    got = histogram_cuda.order0_hist(torch.from_numpy(units),
                                     torch.from_numpy(nv))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_order0_lengths_and_tables_match_jax():
    units, nv = _ragged(10, 4096, 4)
    counts = histogram_cuda.order0_hist_plain(
        torch.from_numpy(units), torch.from_numpy(nv)).numpy()
    lengths = ORDER0.lengths_from_counts(counts)
    ref_lengths = np.asarray(JAX_ORDER0.lengths_from_counts(counts))
    assert lengths.shape == (256,) and lengths.dtype == np.uint8
    np.testing.assert_array_equal(lengths, ref_lengths)
    ref = JAX_ORDER0.tables_from_lengths(ref_lengths)
    got = ORDER0.tables_from_lengths(lengths, "cpu")
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.is_contiguous(), k
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), k)


def _order0_case(seed: int, B: int, n: int, ragged: bool = True):
    """Units over 16 symbols whose order-0 code lengths are 1..15 (two at
    15); ragged n_valid with zeros past it, or every unit full."""
    rng = np.random.default_rng(seed)
    alphabet = rng.choice(256, 16, replace=False)
    lengths = np.zeros(256, np.int32)
    lengths[alphabet] = rng.permutation(list(range(1, 16)) + [15])
    units = alphabet[rng.integers(0, 16, (B, n))].astype(np.uint8)
    nv = np.full(B, n, np.int32)
    if ragged:
        nv[0] = 0
        nv[2] = n // 2 + 1
        nv[-1] = 5
    units[np.arange(n)[None, :] >= nv[:, None]] = 0
    t = JAX_ORDER0.tables_from_lengths(jnp.asarray(lengths))
    return units, nv, {k: np.asarray(v) for k, v in t.items()}


def _port_decode(words, nv, tables, n_out):
    t = tables_from_numpy(tables, "cpu")
    return decode_cuda.decode_units(
        torch.from_numpy(np.array(words, np.uint32).view(np.int32)),
        torch.from_numpy(nv), t["lim"], t["base"], t["first_code"],
        t["sorted_syms"], n_out=n_out, markov=False).numpy()


def test_order0_decode_matches_decode_blocks():
    B, n = 24, 200
    units, nv, tables = _order0_case(5, B, n)
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    words, _ = jax_bitpack.encode_blocks_merge(
        jnp.asarray(units), jnp.asarray(nv), jt["codes"], jt["lengths"])
    ref = np.asarray(jax_bitpack.decode_blocks(
        words, jnp.asarray(nv), jt["lim"], jt["base"], jt["first_code"],
        jt["sorted_syms"], n_out=n, markov=False))
    got = _port_decode(np.asarray(words), nv, tables, n)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, units)


def test_order0_decode_matches_pallas_interpret():
    """decode_blocks_pallas's order-0 call, as tests/test_decode_pallas.py
    runs it on the CPU."""
    B, n = 8, 64
    units, nv, tables = _order0_case(6, B, n, ragged=False)
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    words, _ = jax_bitpack.encode_blocks_merge(
        jnp.asarray(units), jnp.asarray(nv), jt["codes"], jt["lengths"])
    ref = np.asarray(decode_pallas.decode_blocks_pallas(
        words, jt["lim"], jt["base"], jt["first_code"], jt["sorted_syms"],
        n_out=n, markov=False, interpret=True, out_chunk=16))
    got = _port_decode(np.asarray(words), nv, tables, n)
    np.testing.assert_array_equal(got, ref[:B, :n])
    np.testing.assert_array_equal(got, units)


def test_byte_expansion_matches_jax():
    rng = np.random.default_rng(8)
    lens = np.array([5, 0, 13, 4, 1, 8], np.int32)
    payload = rng.integers(0, 256, int(lens.sum()) + 3, dtype=np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    W = 5
    ref = np.asarray(jax_bitpack.device_expand_words(
        jnp.asarray(payload), jnp.asarray(offs), jnp.asarray(lens), W))
    got = bitpack.device_expand_words(
        torch.from_numpy(payload), torch.from_numpy(offs[:-1]),
        torch.from_numpy(lens), W)
    assert got.dtype == torch.int32 and got.shape == (len(lens), W)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_order0_containers_identical_and_cross_decode(name):
    data = CORPORA[name]
    ours = mhc_tpu_torch.compress(data, mode="huffman", device="cpu")
    ref = jax_api.compress(data, mode="huffman")
    assert ours == ref
    assert mhc_tpu_torch.decompress(ref, device="cpu") == data
    assert jax_api.decompress(ours) == data


def test_order0_engine_container_and_literal_units():
    data = CORPORA["bench_1m"]
    st = engine.stage(data, mode="huffman", device="cpu")
    enc = engine.encode(st)
    blob = engine.assemble_container(enc, zlib.crc32(data))
    assert blob == mhc_tpu_torch.compress(data, mode="huffman",
                                          device="cpu")
    meta = container.parse_container(blob)
    assert meta.flags & container.FLAG_RAW_UNITS
    assert not meta.flags & container.FLAG_ALIGNED_PAYLOAD
    raw = bitpack.raw_unit_mask(meta.byte_lengths, st.n_valid.numpy(),
                                False)
    assert (enc.n_units, int(raw.sum())) == (64, 27)
    assert engine.fetch_bytes(enc, engine.decode(enc)) == data


@pytest.mark.parametrize("block_size,du", [(4096, 1024), (16384, 16384)])
def test_order0_other_unit_sizes(block_size, du):
    """Substreams, and the whole-block layout (exact bit lengths in the
    index, no literal units)."""
    data = english_like(50_000, seed=9)
    st = engine.stage(data, mode="huffman", block_size=block_size,
                      decode_unit=du, device="cpu")
    blob = engine.assemble_container(engine.encode(st), zlib.crc32(data))
    assert blob == jax_api.compress(data, mode="huffman",
                                    block_size=block_size, decode_unit=du)
    assert mhc_tpu_torch.decompress(blob, device="cpu") == data
    assert jax_api.decompress(blob) == data


def test_empty_order0_container_has_a_256_entry_header():
    blob = mhc_tpu_torch.compress(b"", mode="huffman", device="cpu")
    assert blob == jax_api.compress(b"", mode="huffman")
    assert container.parse_container(blob).lengths.shape == (256,)
    assert mhc_tpu_torch.decompress(blob, device="cpu") == b""


def test_device_none_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        config.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        mhc_tpu_torch.compress(b"abc", mode="huffman")
    with pytest.raises(RuntimeError, match="CUDA"):
        mhc_tpu_torch.decompress(jax_api.compress(b"abc", mode="huffman"))
    assert config.resolve_device("cpu") == torch.device("cpu")
