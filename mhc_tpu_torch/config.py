"""Device resolution — the only setting the port has.

The reference's performance knobs (`mhc_tpu/config.py`: pack, lookup,
histogram and decode variants, chunk sizes) chose between TPU kernel
variants; the port has one kernel per contract, so none of them exists
here. Callers pass `device` explicitly to `stage`, `compress` and
`decompress`; None means the first CUDA card when there is one, else
the CPU (where every kernel runs as its plain PyTorch version).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)
