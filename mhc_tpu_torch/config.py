"""Device resolution — the port's only setting.

The reference's performance knobs (`mhc_tpu/config.py`: pack, lookup,
histogram and decode variants, chunk sizes) chose between TPU kernel
variants; the port has one kernel per contract. The one choice a caller
makes is `pack_method`, a parameter of `compress` and `engine.encode`;
where the table build runs follows from where the counts lie
(`EntropyModel.tables_for`). Callers pass `device` to `stage`,
`compress` and `decompress`; None means the first CUDA card, and raises
when there is none. The CPU, where every kernel runs as its plain
PyTorch version, is used only when the caller names it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mhc_tpu_torch: device=None means the first CUDA card, but "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)

