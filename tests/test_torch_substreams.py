"""Sub-stream (decode unit) container layout in the port
(tests/test_substreams.py against mhc_tpu_torch): unit sizes, the u16
limit, the legacy layout, index and table serialisation — and the same
bytes as the JAX package where both write a container."""

import numpy as np
import pytest

from mhc_tpu import api as jax_api
from mhc_tpu import container as jax_container
from mhc_tpu_torch import api, container
from tests.corpus import english_like, mixed_binary


def test_substream_flag_set_and_parsed():
    data = english_like(300_000)
    blob = api.compress(data, mode="markov", block_size=65536,
                        decode_unit=2048, device="cpu")
    meta = container.parse_container(blob)
    assert meta.flags & container.FLAG_SUBSTREAMS
    assert meta.decode_unit == 2048
    assert len(meta.byte_lengths) == (300_000 + 2047) // 2048
    assert api.decompress(blob, device="cpu") == data
    assert blob == jax_api.compress(data, mode="markov", block_size=65536,
                                    decode_unit=2048)


def test_legacy_when_unit_equals_block():
    data = english_like(100_000)
    blob = api.compress(data, mode="markov", block_size=4096,
                        decode_unit=4096, device="cpu")
    meta = container.parse_container(blob)
    assert not (meta.flags & container.FLAG_SUBSTREAMS)
    assert meta.decode_unit is None
    # the legacy index holds exact bit lengths, one u32 per block
    assert meta.index_bytes == 4 * meta.n_blocks
    assert np.array_equal(meta.byte_lengths,
                          (meta.bit_lengths + 31) // 32 * 4)
    assert api.decompress(blob, device="cpu") == data


@pytest.mark.parametrize("du", [256, 1024, 2048, 8192])
def test_unit_sizes_roundtrip(du):
    data = mixed_binary(200_000, seed=13)
    blob = api.compress(data, mode="markov", block_size=65536,
                        decode_unit=du, device="cpu")
    assert api.decompress(blob, device="cpu") == data


@pytest.mark.parametrize("kwargs,match", [
    (dict(block_size=65536, decode_unit=3000), "power of two"),
    (dict(block_size=1 << 20, decode_unit=1 << 17), "u16"),
    (dict(block_size=60000), "power of two")],
    ids=["unit_not_pow2", "u16_limit", "block_not_pow2"])
def test_invalid_units_rejected(kwargs, match):
    with pytest.raises(ValueError, match=match):
        api.compress(b"x" * 1000, device="cpu", **kwargs)


def test_u16_limit_is_the_worst_case_stream():
    """The largest unit below a block whose worst-case stream (15 bits a
    symbol) stays under 64 KB is 32 KB; a unit equal to the block uses
    the legacy u32 index and has no such limit."""
    assert api.resolve_decode_unit(1 << 20, 1 << 15) == 1 << 15
    with pytest.raises(ValueError, match="u16"):
        api.resolve_decode_unit(1 << 20, 1 << 16)
    assert api.resolve_decode_unit(1 << 16, 1 << 16) == 1 << 16
    assert api.resolve_decode_unit(4096, None) == 4096       # clamped
    assert api.resolve_decode_unit(65536, None, markov=False) == 16384


def test_substream_overhead_is_small():
    data = english_like(1 << 20)
    legacy = api.compress(data, mode="markov", block_size=65536,
                          decode_unit=65536, device="cpu")
    sub = api.compress(data, mode="markov", block_size=65536,
                       decode_unit=2048, device="cpu")
    assert len(sub) < len(legacy) * 1.005


@pytest.mark.parametrize("n", [1, 100, 2047, 2048, 2049, 4096])
def test_ragged_tail_single_unit(n):
    data = english_like(n, seed=n)
    blob = api.compress(data, mode="markov", decode_unit=2048, device="cpu")
    assert api.decompress(blob, device="cpu") == data


def _index_cases():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 4000, 1000), np.full(64, 257), np.array([0]),
            np.array([65535]), rng.integers(0, 2, 500)]


@pytest.mark.parametrize("case", range(5))
def test_index_pack_unpack_inverse(case):
    lens = _index_cases()[case].astype(np.int64)
    for pack, unpack, jax_pack in (
            (container.pack_index, container.unpack_index,
             jax_container.pack_index),
            (container.pack_index_grouped, container.unpack_index_grouped,
             jax_container.pack_index_grouped),
            (container.pack_index_entropy, container.unpack_index_entropy,
             jax_container.pack_index_entropy)):
        raw = pack(lens)
        assert raw == jax_pack(lens)
        back, off = unpack(b"xx" + raw, 2, len(lens))
        assert off == 2 + len(raw)
        assert (back == lens).all()


def test_table_serialize_parse_inverse():
    rng = np.random.default_rng(4)
    lens0 = rng.integers(0, 16, 256).astype(np.uint8)
    raw = container.serialize_tables(container.MODE_ORDER0, lens0)
    assert raw == jax_container.serialize_tables(container.MODE_ORDER0, lens0)
    back, off = container.parse_tables(container.MODE_ORDER0, raw, 0)
    assert off == len(raw) and (back == lens0).all()
    lensM = rng.integers(0, 16, (256, 256)).astype(np.uint8)
    lensM[rng.random(256) < 0.5] = 0  # absent contexts
    for serialize, jax_serialize, packed in (
            (lambda x: container.serialize_tables(container.MODE_MARKOV, x),
             lambda x: jax_container.serialize_tables(
                 container.MODE_MARKOV, x), False),
            (container.serialize_tables_packed,
             jax_container.serialize_tables_packed, True)):
        raw = serialize(lensM)
        assert raw == jax_serialize(lensM)
        back, off = container.parse_tables(container.MODE_MARKOV, raw, 0,
                                           packed=packed)
        assert off == len(raw) and (back == lensM).all()
