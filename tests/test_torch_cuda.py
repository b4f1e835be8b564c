"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. This file imports
torch and mhc_tpu_torch only, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import mhc_tpu_torch
from mhc_tpu_torch import engine
from mhc_tpu_torch.models.entropy import MARKOV
from mhc_tpu_torch.ops.kernels import (_build, decode_cuda, encode_cuda,
                                       histogram_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _data(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"etaoin shrdlu.\n", np.uint8), n // 2)
    noise = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([text, noise]).tobytes()


@pytest.mark.parametrize("n,block,du", [(300_001, 65536, 8192),
                                        (70_000, 8192, 1024),
                                        (5_000, 4096, 4096),
                                        (1_001, 2, 2)])
def test_kernels_equal_plain_versions(dev, n, block, du):
    """Units with and without literals, and a decode unit that is not a
    multiple of 4 (K7's byte-store path)."""
    st = engine.stage(_data(n, n), block_size=block, decode_unit=du,
                      device=dev)
    u, nv = st.units, st.n_valid
    counts = histogram_cuda.markov_hist(u, nv)
    assert torch.equal(counts, histogram_cuda.markov_hist_plain(u, nv))
    lengths = MARKOV.lengths_from_counts(counts.cpu().numpy())
    t = MARKOV.tables_from_lengths(lengths, dev)
    got = encode_cuda.pack_units(u, nv, t["codes"], t["lengths"])
    ref = encode_cuda.pack_units_plain(u, nv, t["codes"], t["lengths"])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    enc = engine.encode(st, lengths=lengths)
    words, n_dec, _, t = engine.decode_inputs(enc)
    args = (words, n_dec, t["lim"], t["base"], t["first_code"],
            t["sorted_syms"])
    out = decode_cuda.decode_units(*args, n_out=du)
    torch.cuda.synchronize()
    assert torch.equal(out, decode_cuda.decode_units_plain(*args, n_out=du))
    assert engine.fetch_bytes(enc, engine.decode(enc)) == _data(n, n)


@pytest.mark.parametrize("data", [b"", b"Q", b"QQ", bytes(4096),
                                  bytes(range(256)) * 16, b"xy" * 65536])
def test_gpu_container_equals_cpu_container(dev, data):
    blob = mhc_tpu_torch.compress(data, device=dev)
    assert blob == mhc_tpu_torch.compress(data, device="cpu")
    assert mhc_tpu_torch.decompress(blob, device=dev) == data


def test_launch_counters_count_kernel_launches(dev):
    st = engine.stage(_data(50_000, 1), device=dev)
    before = (histogram_cuda.markov_hist.launches,
              encode_cuda.pack_units.launches,
              decode_cuda.decode_units.launches)
    engine.decode(engine.encode(st))
    after = (histogram_cuda.markov_hist.launches,
             encode_cuda.pack_units.launches,
             decode_cuda.decode_units.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


def test_failed_build_raises_instead_of_falling_back(dev, monkeypatch):
    def broken(name):
        raise RuntimeError(f"nvcc failed to build {name}")
    monkeypatch.setattr(_build, "build", broken)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(histogram_cuda, "markov_hist_plain", None)
    u = torch.zeros((2, 16), dtype=torch.uint8, device=dev)
    nv = torch.full((2,), 16, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        histogram_cuda.markov_hist(u, nv)
