"""Entropy models: order-0 Huffman and first-order Markov-Huffman.

Counterpart of `mhc_tpu/models/entropy.py`. A model owns the statistics
pass over a unit batch and the shape of its code tables; tables use the
unified [prev, cur] layout so the kernels are mode-agnostic. Order-0
repeats its single table across the 256 context rows, materialised (the
table kernels write them from their grids): the kernels read their
tables through raw pointers, where a stride-0 view would read row 0's
neighbours as garbage. The encode builds lengths and tables from counts
in one call (`tables_for`: on a card one launch of the fused table
build); `lengths_for` and `tables_from_lengths` serve the callers that
need one of the two.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import container
from ..ops import histogram, huffman
from ..ops.kernels import huffman_cuda, tables_cuda
from ..utils import native


@dataclass(frozen=True)
class EntropyModel:
    name: str
    mode: int          # container mode id
    markov: bool

    def histogram(self, units: torch.Tensor,
                  n_valid: torch.Tensor) -> torch.Tensor:
        """int64 counts on the units' device: (256, 256) [prev, cur] for
        Markov, (256,) for order-0."""
        if self.markov:
            return histogram.histogram_markov(units, n_valid)
        return histogram.histogram_order0(units, n_valid)

    def lengths_from_counts(self, counts: np.ndarray) -> np.ndarray:
        """Deterministic uint8 code lengths of the counts' shape ((256,
        256) or (256,)) from host counts: the native C++ builder."""
        scaled = huffman.rescale_counts(np.asarray(counts))
        return native.code_lengths(scaled, huffman.MAX_CODE_LEN)

    def lengths_for(self, counts: torch.Tensor) -> torch.Tensor:
        """uint8 code lengths of int32 or int64 counts, on the counts'
        device and of their shape: K11 where they lie on a CUDA card (no
        fetch; it won at 1 MB and at 100 MB on an H100, PERF.md §6), the
        host builder elsewhere (the reference builds on the device only
        on its chip). Both give the same lengths."""
        if counts.device.type == "cuda":
            return huffman.code_lengths(counts)
        return torch.from_numpy(self.lengths_from_counts(
            counts.numpy().astype(np.int64)))

    def tables_for(self, counts: torch.Tensor, device) -> tuple:
        """(uint8 code lengths of the counts' shape, the table set of
        `tables_from_lengths`) from int32 or int64 counts: on a CUDA card
        one launch of the fused table build where the counts lie (K11
        and K13 in one kernel, `huffman_cuda.code_tables`), elsewhere the
        host build and the plain tables on `device`. Both give the same
        lengths and tables."""
        if counts.device.type != "cuda":
            lengths = self.lengths_for(counts)
            return lengths, self.tables_from_lengths(lengths, device)
        lengths, tables = huffman_cuda.code_tables(
            counts.reshape(-1, 256).contiguous(), 256)
        return lengths.reshape(counts.shape), tables

    def tables_from_lengths(self, lengths, device) -> dict:
        """Full encode+decode table set on `device`, (256, ...) layout,
        every table contiguous. `lengths` (uint8 code lengths) is host
        (numpy) or a tensor, taken where it lies when that is `device`.
        K13 on a card, its plain version elsewhere
        (`tables_cuda.canonical_tables`); order-0's one row of lengths
        gives its tables on all 256 rows."""
        if not torch.is_tensor(lengths):
            lengths = torch.from_numpy(np.ascontiguousarray(lengths,
                                                            np.uint8))
        lengths = lengths.to(device, torch.uint8).reshape(-1, 256)
        return tables_cuda.canonical_tables(lengths.contiguous(), 256)


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
