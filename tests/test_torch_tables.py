"""Host codec core parity: Huffman lengths, canonical tables and the MHTC
container of mhc_tpu_torch against the JAX package (tolerance 0)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mhc_tpu import container as jax_container
from mhc_tpu.models.entropy import MARKOV as JAX_MARKOV
from mhc_tpu.ops import canonical as jax_canonical
from mhc_tpu.ops import huffman as jax_huffman
from mhc_tpu.utils import native as jax_native
from mhc_tpu_torch import container
from mhc_tpu_torch.models.entropy import MARKOV, tables_from_numpy
from mhc_tpu_torch.ops import canonical, huffman
from mhc_tpu_torch.utils import native


def _counts(seed: int) -> np.ndarray:
    """(256, 256) counts with absent contexts, single-symbol contexts and
    contexts deep enough to hit the 15-bit length limit."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 500, (256, 256)).astype(np.int64)
    counts[rng.random((256, 256)) < 0.6] = 0
    counts[:8] = 0
    counts[8:16] = 0
    counts[8:16, 3] = 7
    counts[16:24] = np.floor(1.12 ** np.arange(256)).astype(np.int64) + 1
    return counts


@pytest.mark.parametrize("seed", [0, 1])
def test_lengths_match_jax(seed):
    counts = _counts(seed)
    ref = np.asarray(JAX_MARKOV.lengths_from_counts(counts))
    got = MARKOV.lengths_from_counts(counts)
    np.testing.assert_array_equal(got, ref)
    assert got.max() == huffman.MAX_CODE_LEN
    for row in (9, 20, 100):
        np.testing.assert_array_equal(
            huffman.code_lengths_np(counts[row]),
            jax_huffman.code_lengths_np(counts[row]))
    scaled = huffman.rescale_counts(counts)
    np.testing.assert_array_equal(scaled, jax_huffman.rescale_counts(counts))
    np.testing.assert_array_equal(native.code_lengths(scaled, 15),
                                  jax_native.code_lengths(scaled, 15))


@pytest.mark.parametrize("seed", [0, 1])
def test_canonical_codes_match_jax(seed):
    lengths = JAX_MARKOV.lengths_from_counts(_counts(seed)).astype(np.int32)
    ref = jax_canonical.canonical_codes(jnp.asarray(lengths))
    got = canonical.canonical_codes(torch.from_numpy(lengths))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(ref[k]).astype(np.int64),
                                      err_msg=k)


def test_tables_from_numpy_round_trip():
    lengths = JAX_MARKOV.lengths_from_counts(_counts(2))
    ref = {k: np.asarray(v) for k, v in jax_canonical.canonical_codes(
        jnp.asarray(lengths, jnp.int32)).items()}
    got = tables_from_numpy(ref, "cpu")
    own = MARKOV.tables_from_lengths(lengths, "cpu")
    for k in ref:
        assert torch.equal(got[k], own[k]), k
        np.testing.assert_array_equal(got[k].numpy().astype(ref[k].dtype),
                                      ref[k])


@pytest.mark.parametrize("decode_unit", [8192, 65536])
@pytest.mark.parametrize("crc", [0x1234ABCD, None])
def test_build_and_parse_container_match_jax(decode_unit, crc):
    rng = np.random.default_rng(3)
    lengths = JAX_MARKOV.lengths_from_counts(_counts(3)).astype(np.uint8)
    orig_len = 300_000
    n_units = -(-orig_len // decode_unit)
    bits = rng.integers(1000, 60_000, n_units).astype(np.int64)
    payload = rng.integers(0, 256, int(((bits + 31) // 32 * 4).sum()),
                           dtype=np.uint8).tobytes()
    args = (container.MODE_MARKOV, orig_len, 65536, lengths, bits, payload,
            crc)
    blob = container.build_container(*args, decode_unit=decode_unit)
    assert blob == jax_container.build_container(*args,
                                                 decode_unit=decode_unit)
    meta = container.parse_container(blob)
    ref = jax_container.parse_container(blob)
    for field in ("mode", "orig_len", "block_size", "n_blocks", "flags",
                  "decode_unit", "index_bytes", "payload_off", "crc32"):
        assert getattr(meta, field) == getattr(ref, field), field
    for field in ("lengths", "bit_lengths", "byte_lengths"):
        np.testing.assert_array_equal(getattr(meta, field),
                                      getattr(ref, field))


def test_entropy_decode_matches_reference():
    """A stream the JAX package's metadata coder writes decodes in the
    port's decoder as in the reference's."""
    rng = np.random.default_rng(4)
    syms = np.minimum(rng.geometric(0.3, 5000) - 1, 15).astype(np.uint8)
    lens, coded = jax_container.entropy_encode(syms, 16)
    got, used = native.entropy_decode(coded, lens, syms.size)
    ref, ref_used = jax_native.entropy_decode(coded, lens, syms.size)
    np.testing.assert_array_equal(got, syms)
    np.testing.assert_array_equal(ref, syms)
    assert used == ref_used == len(coded)


def _native_streams(section):
    """The host library's entropy-coded streams of a packed table
    section or an entropy index: [(symbols, code lengths, stream)]."""
    rng = np.random.default_rng(6)
    if section == "tables":
        lengths = JAX_MARKOV.lengths_from_counts(_counts(6)).astype(np.uint8)
        raw, packed = native.write_tables(True, lengths)
        assert packed
        nib = lengths[(lengths > 0).any(axis=1)].reshape(-1)
        return [(nib, container.unpack_nibbles(raw[32:40], (16,)),
                 raw[40:])]
    resid = 300 * rng.integers(0, 2, 5000) + rng.integers(0, 3, 5000)
    raw, form = native.write_index(40 + resid, container.INDEX_GROUPS)
    assert form == 1 and raw[2] == 1    # entropy-coded, high bytes too
    streams, off = [], 3
    for syms in (resid & 255, resid >> 8):
        lens = container.unpack_nibbles(raw[off:off + 128], (256,))
        nb = int.from_bytes(raw[off + 128:off + 132], "little")
        streams.append((syms, lens, raw[off + 132:off + 132 + nb]))
        off += 132 + nb
    assert off == len(raw)
    return streams


@pytest.mark.parametrize("section", ["tables", "index"])
def test_native_entropy_encode_round_trips(section):
    for syms, lens, coded in _native_streams(section):
        got, used = native.entropy_decode(coded, lens, syms.size)
        ref, ref_used = jax_native.entropy_decode(coded, lens, syms.size)
        np.testing.assert_array_equal(got, syms)
        np.testing.assert_array_equal(ref, syms)
        assert used == ref_used == len(coded)
