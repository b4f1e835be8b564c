"""Context-conditioned byte histograms.

Counterpart of `mhc_tpu/ops/histogram.py::histogram_markov`: the
(256, 256) [prev, cur] counts over a unit batch, with the Markov context
reset to 0 at every unit start and positions past n_valid excluded — the
same pairs the encoder later codes. CUDA tensors go through kernel K1,
CPU tensors through its plain version (ops/kernels/histogram_cuda.py).
"""

from __future__ import annotations

import torch

from .kernels import histogram_cuda


def histogram_markov(units: torch.Tensor,
                     n_valid: torch.Tensor) -> torch.Tensor:
    """(R, n) uint8, (R,) int32 -> (256, 256) int32 counts."""
    return histogram_cuda.markov_hist(units, n_valid)
