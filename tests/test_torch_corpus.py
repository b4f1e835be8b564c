"""The port's copy of the benchmark corpus equals the reference's
`bench.make_corpus` byte for byte, at several sizes and seeds: the
digests in chip_smoke.py were computed on the reference's corpus."""

import hashlib

import pytest

import bench
from mhc_tpu_torch.utils import corpus

_SIZES = [0, 1, 4095, 65536, 1 << 20, (3 << 20) + 17]


@pytest.mark.parametrize("n", _SIZES)
@pytest.mark.parametrize("seed", [42, 0, 7])
def test_make_corpus_equals_bench(n, seed):
    got = corpus.make_corpus(n, seed=seed)
    assert len(got) == n
    assert got == bench.make_corpus(n, seed=seed)


def test_default_seed_is_the_benchmark_seed():
    assert (hashlib.sha256(corpus.make_corpus(1 << 16)).digest()
            == hashlib.sha256(bench.make_corpus(1 << 16, seed=42)).digest())
