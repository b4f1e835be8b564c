"""The port's hybrid host/device executor: containers byte-identical to
the JAX package's `api.compress` at every split, for both modes, and a
raise, not a silent fallback, without the native library."""

import pytest

from mhc_tpu import api as jax_api
from mhc_tpu_torch import hybrid
from mhc_tpu_torch.utils import native
from tests.corpus import english_like, mixed_binary

DATA = mixed_binary(250_000, seed=50)


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_hybrid_container_identity(mode, frac):
    blob = hybrid.compress(DATA, mode=mode, host_fraction=frac,
                           device="cpu")
    assert blob == jax_api.compress(DATA, mode=mode)


@pytest.mark.parametrize("frac", [0.0, 0.4, 0.7, 1.0])
def test_hybrid_decompress_roundtrip(frac):
    data = english_like(200_000, seed=51)
    blob = jax_api.compress(data, mode="huffman")
    assert hybrid.decompress(blob, host_fraction=frac, device="cpu") == data


def test_hybrid_decode_of_hybrid_blob():
    data = mixed_binary(150_000, seed=52)
    blob = hybrid.compress(data, host_fraction=0.6, device="cpu")
    assert hybrid.decompress(blob, host_fraction=0.4, device="cpu") == data


def test_hybrid_empty_and_tiny():
    for frac in (0.0, 0.5, 1.0):
        for data in (b"", b"x"):
            blob = hybrid.compress(data, host_fraction=frac, device="cpu")
            assert blob == jax_api.compress(data)
            assert hybrid.decompress(blob, host_fraction=frac,
                                     device="cpu") == data


def test_hybrid_raises_without_native_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="native host library"):
        hybrid.compress(b"abc", device="cpu")
    with pytest.raises(RuntimeError, match="native host library"):
        hybrid.decompress(jax_api.compress(b"abc"), device="cpu")


def test_host_fraction_out_of_range_raises():
    with pytest.raises(ValueError, match="host_fraction"):
        hybrid.compress(b"abc", host_fraction=1.5, device="cpu")
