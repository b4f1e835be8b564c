"""Fixed-seed differential parity: `mhc_tpu_torch.api.compress` writes
`mhc_tpu.api.compress`'s bytes on the random corpus mixes and random
(mode, block_size, decode_unit) of tests/test_fuzz.py, by every pack
method.

The seeds are those on which the JAX package's own fresh-seed size test
has failed (its order-0 container a few bytes over the oracle's): a
byte-identical port inherits that behaviour, so parity is held on fixed
seeds, never on a fresh one.
"""

import functools

import numpy as np
import pytest

from mhc_tpu import api as jax_api
from mhc_tpu_torch import api
from tests.test_fuzz import _random_corpus

SEEDS = [3145778133, 4245388045, 2231337164, 301461312, 3497526871]


@functools.lru_cache(maxsize=None)
def _case(seed: int):
    """test_fuzz_roundtrip_differential's draw for iteration 0 of `seed`,
    the corpus cut to 120 KB, and the JAX package's container."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300_000))
    data = _random_corpus(rng, n)[:120_000]
    mode = ("markov", "huffman")[int(rng.integers(2))]
    block_size = int(2 ** rng.integers(12, 18))
    du_max = min(block_size, 16384)
    decode_unit = int(2 ** rng.integers(10, du_max.bit_length()))
    kw = dict(mode=mode, block_size=block_size, decode_unit=decode_unit)
    return data, kw, jax_api.compress(data, **kw)


@pytest.mark.parametrize("pack_method", ["fused", "dense", "pallas"])
@pytest.mark.parametrize("seed", SEEDS)
def test_compress_equals_jax_compress(seed, pack_method):
    data, kw, ref = _case(seed)
    blob = api.compress(data, device="cpu", pack_method=pack_method, **kw)
    assert blob == ref, f"seed={seed} {kw} n={len(data)}"
    if pack_method == "fused":
        assert api.decompress(ref, device="cpu") == data
        assert jax_api.decompress(blob) == data


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("seed", SEEDS)
def test_default_parameters_equal_jax_compress(seed, mode):
    """The default-parameter containers of test_fuzz_size_vs_oracle's
    corpus (cut to 150 KB): the same bytes, so the same size against the
    oracle."""
    data = _random_corpus(np.random.default_rng(seed), 1 << 20)[:150_000]
    assert (api.compress(data, mode=mode, device="cpu")
            == jax_api.compress(data, mode=mode))
