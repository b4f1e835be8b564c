"""Literal (raw) units in the port — container FLAG_RAW_UNITS
(tests/test_raw_units.py against mhc_tpu_torch).

The substitution rule is the same in the torch helper, the engine, the
host-bytes API and the native C++ host codec (byte-identical
containers, also to the JAX package's); detection is length-based and
unambiguous; round trips stay bit-exact. The reference's repacked decode
is not ported: K7 skips literal units by n_dec = 0, which the last test
holds.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhc_tpu import api as jax_api
from mhc_tpu.ops import bitpack as jax_bitpack
from mhc_tpu_torch import api, container, engine, hybrid
from mhc_tpu_torch.ops import bitpack
from tests.corpus import english_like, mixed_binary


def _noise(n, seed=7):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _mixed_noise(n, seed=9):
    """Half text, half incompressible — literal and coded units mix."""
    t = english_like(n // 2, seed=seed)
    return t + _noise(n - len(t), seed + 1)


def _raw_mask(blob: bytes, n: int) -> np.ndarray:
    meta = container.parse_container(blob)
    du = meta.decode_unit
    nv = np.full(len(meta.byte_lengths), du, np.int64)
    nv[-1] = n - (len(nv) - 1) * du
    return bitpack.raw_unit_mask(
        meta.byte_lengths, nv,
        bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD))


@pytest.mark.parametrize("aligned", [True, False])
def test_substitute_raw_units_helper(aligned):
    """Handcrafted: an expanding unit is replaced by BE-packed literal
    words with bits = n_valid * 8; a compressible one is untouched; the
    JAX helper gives the same."""
    units = np.array([[1, 2, 3, 4, 5, 6, 7, 8],
                      [9, 9, 9, 9, 9, 9, 0, 0]], np.uint8)
    nv = np.array([8, 6], np.int32)
    words = np.full((2, 5), 0xABCD, np.int32)
    for bits in ([64, 5], [64, 41]):
        w2, b2 = bitpack.substitute_raw_units(
            torch.from_numpy(words), torch.tensor(bits, dtype=torch.int32),
            torch.from_numpy(units), torch.from_numpy(nv), aligned)
        rw, rb = jax_bitpack.substitute_raw_units(
            jnp.asarray(words.astype(np.uint32)),
            jnp.asarray(np.array(bits, np.int64)), jnp.asarray(units),
            jnp.asarray(nv), aligned)
        np.testing.assert_array_equal(w2.numpy().view(np.uint32),
                                      np.asarray(rw))
        np.testing.assert_array_equal(b2.numpy(), np.asarray(rb))
        w2, b2 = w2.numpy(), b2.numpy()
        assert b2[0] == 64
        assert w2[0, 0] == 0x01020304 and w2[0, 1] == 0x05060708
        assert (w2[0, 2:] == 0).all()
        if bits[1] == 5:
            assert b2[1] == 5 and (w2[1] == 0xABCD).all()    # untouched
    if not aligned:
        # bits = 41 -> 6 bytes == nv -> literal, bytes past nv zeroed
        assert b2[1] == 48 and w2[1, 1] == 0x09090000


def test_substitute_raw_units_rejects_a_narrow_row():
    with pytest.raises(ValueError, match="literal"):
        bitpack.substitute_raw_units(
            torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 8), dtype=torch.uint8),
            torch.full((1,), 8, dtype=torch.int32), True)


def test_raw_mask_roundtrip_rule():
    nv = np.array([8192, 8192, 5, 0], np.int64)
    m = bitpack.raw_unit_mask(np.array([8192, 8188, 8, 0]), nv, True)
    assert list(m) == [True, False, True, False]
    m = bitpack.raw_unit_mask(np.array([8192, 8191, 5, 0]), nv, False)
    assert list(m) == [True, False, True, False]


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_noise_roundtrip_and_flag(mode):
    data = _noise(300_000)
    blob = api.compress(data, mode=mode, decode_unit=2048, device="cpu")
    meta = container.parse_container(blob)
    assert meta.flags & container.FLAG_RAW_UNITS
    if mode == "huffman":
        # a uniform table: bits == nv * 8, the literal fires at equality
        assert _raw_mask(blob, len(data))[:-1].all()
    assert api.decompress(blob, device="cpu") == data
    assert (int(meta.byte_lengths.sum())
            <= len(data) + 4 * len(meta.byte_lengths))
    assert blob == jax_api.compress(data, mode=mode, decode_unit=2048)


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_mixed_roundtrip_has_literal_and_coded_units(mode):
    data = _mixed_noise(600_000)
    blob = api.compress(data, mode=mode, device="cpu")
    assert api.decompress(blob, device="cpu") == data
    raw = _raw_mask(blob, len(data))
    assert raw.any() and not raw.all()


def test_ragged_last_unit_raw():
    """A short, incompressible final unit is a literal of its true byte
    count (order-0: noise under the text-skewed global table expands)."""
    data = english_like(100_000) + _noise(777)
    blob = api.compress(data, mode="huffman", decode_unit=2048,
                        device="cpu")
    assert api.decompress(blob, device="cpu") == data
    meta = container.parse_container(blob)
    assert not meta.flags & container.FLAG_ALIGNED_PAYLOAD
    last_nv = len(data) - (len(meta.byte_lengths) - 1) * 2048
    assert meta.byte_lengths[-1] == last_nv


@pytest.mark.parametrize("pack_method", ["fused", "dense", "pallas"])
def test_engine_container_identity_with_raw(pack_method):
    """engine.assemble_container == api.compress on literal-heavy data,
    by every pack method."""
    data = _mixed_noise(400_000)
    ref = api.compress(data, mode="markov", device="cpu")
    st = engine.stage(data, mode="markov", device="cpu")
    enc = engine.encode(st, pack_method=pack_method)
    assert engine.assemble_container(
        enc, zlib.crc32(data) & 0xFFFFFFFF) == ref
    if pack_method == "fused":
        assert engine.fetch_bytes(enc, engine.decode(enc)) == data
        assert ref == jax_api.compress(data, mode="markov")


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_hybrid_container_identity_with_raw(frac):
    """The native C++ host encoder's literal rule is the device's."""
    data = _mixed_noise(500_000, seed=17)
    ref = api.compress(data, mode="markov", device="cpu")
    assert hybrid.compress(data, mode="markov", host_fraction=frac,
                           device="cpu") == ref
    if frac:
        assert hybrid.decompress(ref, host_fraction=frac,
                                 device="cpu") == data


@pytest.mark.parametrize("aligned", [True, False])
def test_detection_matches_substitution_rule_boundary(aligned):
    """Decode-side detection agrees with encode-side substitution at
    every boundary value of (bits, n_valid), for both layouts; the torch
    substitution fires at exactly the same values."""
    for nv in (2048, 2045, 5, 1):
        bits = np.arange(max(8 * nv - 40, 1), 8 * nv + 1)
        if aligned:
            fires = (bits + 31) // 32 >= (nv + 3) // 4
        else:
            fires = (bits + 7) // 8 >= nv
        stored = np.where(fires, nv * 8, bits)
        sl = (stored + 31) // 32 * 4 if aligned else (stored + 7) // 8
        det = bitpack.raw_unit_mask(sl, np.full(len(bits), nv), aligned)
        assert np.array_equal(det, fires), (aligned, nv)
        R = len(bits)
        _, b2 = bitpack.substitute_raw_units(
            torch.zeros((R, 2048 // 4 + 1), dtype=torch.int32),
            torch.from_numpy(bits.astype(np.int32)),
            torch.zeros((R, 2048), dtype=torch.uint8),
            torch.full((R,), nv, dtype=torch.int32), aligned)
        assert np.array_equal(b2.numpy() == nv * 8,
                              fires | (bits == nv * 8)), (aligned, nv)


def test_engine_order0_near_incompressible_roundtrip():
    """Order-0 engine decode on coded units near the literal boundary
    (noise under a mildly skewed global table): detection follows the
    container layout, not the engine's word counts."""
    rng = np.random.default_rng(101)
    data = (english_like(40_000, seed=3)
            + rng.integers(0, 256, 230_000, dtype=np.uint8).tobytes())
    st = engine.stage(data, mode="huffman", decode_unit=2048, device="cpu")
    enc = engine.encode(st)
    assert engine.fetch_bytes(enc, engine.decode(enc)) == data


def test_decode_skips_literal_units():
    """The decode kernel is handed n_dec = 0 for exactly the literal
    units, whose rows come from the literal overwrite."""
    data = _mixed_noise(400_000, seed=23)
    st = engine.stage(data, mode="huffman", decode_unit=2048, device="cpu")
    enc = engine.encode(st)
    _, n_dec, raw, _ = engine.decode_inputs(enc)
    assert raw.any() and not raw.all()
    nv = st.n_valid.numpy()
    assert np.array_equal(n_dec.numpy(), np.where(raw, 0, nv))
    assert np.array_equal(
        raw, bitpack.raw_unit_mask(enc.byte_lens, nv, enc.aligned))
    assert engine.fetch_bytes(enc, engine.decode(enc)) == data


def test_order0_mixed_payload_within_information_bound():
    data = mixed_binary(1 << 20, seed=80)
    blob = api.compress(data, mode="huffman", device="cpu")
    assert api.decompress(blob, device="cpu") == data
    meta = container.parse_container(blob)
    assert (int(meta.byte_lengths.sum())
            <= len(data) + len(meta.byte_lengths))
