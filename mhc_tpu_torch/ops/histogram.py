"""Byte histograms of a unit batch, the statistics pass of each model.

Counterpart of `mhc_tpu/ops/histogram.py`: `histogram_markov` is the
(256, 256) [prev, cur] counts, with the Markov context reset to 0 at
every unit start; `histogram_order0` is the (256,) byte counts. Both
exclude positions past n_valid — the same symbols the encoder later
codes. Counts are int64, exact past 2**31 in one cell (the reference's
are int32). CUDA tensors go through kernels K1 and K2, CPU tensors through
their plain versions (ops/kernels/histogram_cuda.py).
"""

from __future__ import annotations

import torch

from .kernels import histogram_cuda


def histogram_markov(units: torch.Tensor,
                     n_valid: torch.Tensor) -> torch.Tensor:
    """(R, n) uint8, (R,) int32 -> (256, 256) int64 counts."""
    return histogram_cuda.markov_hist(units, n_valid)


def histogram_order0(units: torch.Tensor,
                     n_valid: torch.Tensor) -> torch.Tensor:
    """(R, n) uint8, (R,) int32 -> (256,) int64 counts."""
    return histogram_cuda.order0_hist(units, n_valid)
