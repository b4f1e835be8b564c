"""K1 parity: mhc_tpu_torch's Markov histogram against the JAX package.

The port's CPU path is K1's plain version (bincount over the valid
(prev, cur) pairs); it must equal the reference's XLA matmul histogram and
its Pallas kernel (interpret mode, default variant v4b) exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mhc_tpu.ops import histogram
from mhc_tpu.ops.kernels import histogram_pallas
from mhc_tpu_torch.ops import histogram as port_histogram
from mhc_tpu_torch.ops.kernels import histogram_cuda
from tests.corpus import mixed_binary


def _blocks(ragged: bool):
    """The shapes of tests/test_histogram_pallas.py: 10 units of 4 KB."""
    data = np.frombuffer(mixed_binary(40_000, seed=70), np.uint8)
    B, n = 10, 4096
    padded = np.zeros(B * n, np.uint8)
    padded[: data.size] = data
    n_valid = np.full(B, n, np.int32)
    if ragged:
        n_valid[-1] = data.size - (B - 1) * n
        n_valid[3] = 17
    return padded.reshape(B, n), n_valid


@pytest.mark.parametrize("ragged", [False, True])
def test_histogram_matches_jax_matmul(ragged):
    units, nv = _blocks(ragged)
    ref = np.asarray(histogram.histogram_markov(
        jnp.asarray(units), jnp.asarray(nv), method="matmul"))
    got = port_histogram.histogram_markov(torch.from_numpy(units),
                                          torch.from_numpy(nv))
    assert got.dtype == torch.int64 and got.shape == (256, 256)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_histogram_matches_pallas_interpret():
    units, nv = _blocks(ragged=True)
    ref = np.asarray(histogram_pallas.markov_hist_pallas(
        jnp.asarray(units), jnp.asarray(nv), interpret=True, variant="v4b"))
    got = port_histogram.histogram_markov(torch.from_numpy(units),
                                          torch.from_numpy(nv))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("unit", [[0], [0, 0, 1]], ids=["zeros", "001"])
def test_histogram_past_16_bits_matches_jax_matmul(unit):
    """24 units of 4 KB of zeros: pair (0, 0) counted 98,304 times; 72 of
    [0, 0, 1] repeated: (0, 0) and (0, 1), the two halves of one of K1's
    words on the card, each past 2^16: the count range that K1's 16-bit
    fields carry into the global table."""
    R = 24 * len(unit)
    units = np.resize(np.array(unit, np.uint8), R * 4096).reshape(R, 4096)
    nv = np.full(R, 4096, np.int32)
    ref = np.asarray(histogram.histogram_markov(
        jnp.asarray(units), jnp.asarray(nv), method="matmul"))
    assert ref[0, 0] > 1 << 16 and (len(unit) == 1 or ref[0, 1] > 1 << 16)
    got = histogram_cuda.markov_hist_plain(torch.from_numpy(units),
                                           torch.from_numpy(nv))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_histogram_context_reset_and_mask():
    units = torch.tensor([[1, 2, 3, 9], [4, 5, 7, 7]], dtype=torch.uint8)
    nv = torch.tensor([3, 2], dtype=torch.int32)
    got = histogram_cuda.markov_hist_plain(units, nv)
    want = np.zeros((256, 256), np.int32)
    for p, c in [(0, 1), (1, 2), (2, 3), (0, 4), (4, 5)]:
        want[p, c] += 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_wrapper_checks_inputs():
    units = torch.zeros((2, 8), dtype=torch.uint8)
    nv = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        histogram_cuda.markov_hist(units.to(torch.int32), nv)
    with pytest.raises(ValueError):
        histogram_cuda.markov_hist(units, nv.to(torch.int64))
    # no silent fallback for devices other than the CPU and CUDA
    with pytest.raises(ValueError):
        histogram_cuda.markov_hist(units.to("meta"), nv.to("meta"))
