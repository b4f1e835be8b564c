"""Entropy models: first-order Markov-Huffman (and order-0, declared).

Counterpart of `mhc_tpu/models/entropy.py`. A model owns the statistics
pass over a unit batch and the shape of its code tables; tables use the
unified [prev, cur] layout so the kernels are mode-agnostic. Order-0 is
declared so containers of both modes parse, but coding it is not ported
yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import container
from ..ops import canonical, histogram, huffman

_ORDER0_TODO = "order-0 is ROADMAP item 7"


@dataclass(frozen=True)
class EntropyModel:
    name: str
    mode: int          # container mode id
    markov: bool

    def require_markov(self) -> None:
        if not self.markov:
            raise NotImplementedError(_ORDER0_TODO)

    def histogram(self, units: torch.Tensor,
                  n_valid: torch.Tensor) -> torch.Tensor:
        """(256, 256) int32 [prev, cur] counts on the units' device."""
        self.require_markov()
        return histogram.histogram_markov(units, n_valid)

    def lengths_from_counts(self, counts: np.ndarray) -> np.ndarray:
        """Deterministic (256, 256) uint8 code lengths from host counts:
        the native C++ builder, or its bit-identical numpy twin where the
        library cannot be built."""
        self.require_markov()
        from ..utils import native
        scaled = huffman.rescale_counts(np.asarray(counts))
        return native.code_lengths(scaled, huffman.MAX_CODE_LEN)

    def tables_from_lengths(self, lengths, device) -> dict:
        """Full encode+decode table set on `device`, (256, ...) layout."""
        self.require_markov()
        return canonical.canonical_codes(
            torch.as_tensor(np.asarray(lengths, np.int64), device=device))


def tables_from_numpy(tables_np: dict, device) -> dict:
    """The dict `mhc_tpu.ops.canonical.canonical_codes` returns (as numpy
    arrays) -> the port's int32 tensors on `device`. Every table value is
    below 2**31, so uint32 arrays keep their values."""
    return {k: torch.from_numpy(np.asarray(v).astype(np.int32)).to(device)
            for k, v in tables_np.items()}


ORDER0 = EntropyModel(name="huffman", mode=container.MODE_ORDER0,
                      markov=False)
MARKOV = EntropyModel(name="markov", mode=container.MODE_MARKOV, markov=True)

_BY_NAME = {"huffman": ORDER0, "order0": ORDER0, "markov": MARKOV}
_BY_MODE = {container.MODE_ORDER0: ORDER0, container.MODE_MARKOV: MARKOV}


def get_model(name_or_mode) -> EntropyModel:
    if isinstance(name_or_mode, EntropyModel):
        return name_or_mode
    if isinstance(name_or_mode, str):
        try:
            return _BY_NAME[name_or_mode.lower()]
        except KeyError:
            raise ValueError(
                f"unknown mode {name_or_mode!r}; expected one of "
                f"{sorted(_BY_NAME)}") from None
    return _BY_MODE[int(name_or_mode)]
