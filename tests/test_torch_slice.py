"""The ported Markov slice end to end against the JAX package: the same
container bytes, and each package decodes the other's containers
(order-0: tests/test_torch_order0.py)."""

import hashlib
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
import mhc_tpu_torch
from bench import make_corpus
from mhc_tpu import api as jax_api
from mhc_tpu_torch import container, engine
from mhc_tpu_torch.ops import bitpack
from tests.corpus import ADVERSARIAL, english_like, mixed_binary

CORPORA = dict(ADVERSARIAL)
CORPORA["english_200k"] = english_like(200_000)
CORPORA["mixed_300k"] = mixed_binary(300_000)
# 1 MB of the main-path corpus: 24 of its 128 units are stored literally
CORPORA["bench_1m"] = make_corpus(1 << 20)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_containers_identical_and_cross_decode(name):
    data = CORPORA[name]
    ours = mhc_tpu_torch.compress(data, device="cpu")
    ref = jax_api.compress(data)
    assert ours == ref
    assert mhc_tpu_torch.decompress(ref, device="cpu") == data
    assert jax_api.decompress(ours) == data


def test_bench_corpus_exercises_literal_units():
    data = CORPORA["bench_1m"]
    st = engine.stage(data, device="cpu")
    enc = engine.encode(st)
    meta = container.parse_container(engine.assemble_container(enc, None))
    nv = st.n_valid.numpy()
    raw = bitpack.raw_unit_mask(meta.byte_lengths, nv, True)
    assert meta.flags & container.FLAG_RAW_UNITS
    assert 0 < raw.sum() < raw.size
    out = engine.decode(enc)
    assert out.shape == (enc.n_units, enc.decode_unit)
    assert engine.fetch_bytes(enc, out) == data


def test_engine_container_matches_api_with_other_unit_sizes():
    data = english_like(50_000, seed=9)
    for block_size, du in [(4096, 1024), (16384, 16384)]:
        st = engine.stage(data, block_size=block_size, decode_unit=du,
                          device="cpu")
        blob = engine.assemble_container(engine.encode(st),
                                         zlib.crc32(data))
        assert blob == jax_api.compress(data, block_size=block_size,
                                        decode_unit=du)
        assert mhc_tpu_torch.decompress(blob, device="cpu") == data


def test_bench_corpus_4mb_digest():
    """The 4 MB main-path corpus: both packages write the container whose
    digest chip_smoke.py keeps."""
    data = make_corpus(4 << 20)
    ours = mhc_tpu_torch.compress(data, device="cpu")
    ref = jax_api.compress(data)
    assert hashlib.sha256(ours).hexdigest() == chip_smoke.REF_4MB_SHA256
    assert hashlib.sha256(ref).hexdigest() == chip_smoke.REF_4MB_SHA256


def test_corrupt_payload_fails_crc():
    data = english_like(20_000)
    blob = bytearray(mhc_tpu_torch.compress(data, device="cpu"))
    blob[-10] ^= 0x40
    with pytest.raises(ValueError, match="crc32"):
        mhc_tpu_torch.decompress(bytes(blob), device="cpu")


def test_staged_tensors_live_on_the_requested_device():
    st = engine.stage(b"abc" * 1000, device=torch.device("cpu"))
    assert st.units.device.type == "cpu" and st.units.dtype == torch.uint8
    assert st.n_valid.dtype == torch.int32
    assert np.array_equal(st.n_valid.numpy(), [3000])
