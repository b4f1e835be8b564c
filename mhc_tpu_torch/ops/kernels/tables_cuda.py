"""K13 — canonical code tables from code lengths: CUDA kernel wrapper.

Kernel: csrc/tables.cu (sm_90a), one 256-thread block per output row. It
replaces mhc_tpu/ops/canonical.py::canonical_codes, an XLA stage on the
TPU; its plain version is `ops/canonical.py::canonical_tables_plain`.
It takes the uint8 lengths as K11 writes them (or as uploaded from the
host) and writes all six int32 tables in one launch, order-0's 256
broadcast rows included. Launch-bound: under a megabyte moved.
"""

from __future__ import annotations

import ctypes

import torch

from .. import canonical
from ..huffman import MAX_CODE_LEN
from . import _build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = [_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P]
_L = MAX_CODE_LEN + 1
# the tables in the order of the kernel's arguments (and of
# `canonical.canonical_codes`' dict), with their widths
_LAYOUT = (("codes", 256), ("lengths", 256), ("lim", _L), ("base", _L),
           ("first_code", _L), ("sorted_syms", 256))


def canonical_tables(lengths: torch.Tensor, rows: int) -> dict:
    """(L, 256) uint8 code lengths, L == rows or 1 -> the dict of
    `canonical.canonical_codes` as (rows, ...) int32 tables, each
    contiguous, on the lengths' device; L == 1 repeats its tables over
    the rows. CPU tensors take the plain version; CUDA tensors launch
    K13."""
    dev = _build.require_cuda_or_cpu(lengths)
    if (lengths.dtype != torch.uint8 or lengths.dim() != 2
            or lengths.shape[1] != 256):
        raise ValueError("lengths must be an (L, 256) uint8 tensor")
    if lengths.shape[0] not in (1, rows):
        raise ValueError(f"{lengths.shape[0]} rows of lengths for {rows} "
                         "rows of tables")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    if dev == "cpu":
        return canonical.canonical_tables_plain(lengths, rows)
    lib, fn = _build.load("tables", "mhc_canonical_tables", _ARGTYPES)
    buf = torch.empty(rows * sum(w for _, w in _LAYOUT), dtype=torch.int32,
                      device=lengths.device)
    out, at = {}, 0
    for name, width in _LAYOUT:
        out[name] = buf[at: at + rows * width].view(rows, width)
        at += rows * width
    if rows:
        rc = fn(lengths.data_ptr(), lengths.shape[0], rows,
                *(out[name].data_ptr() for name, _ in _LAYOUT),
                _build.stream_ptr(lengths.device))
        _build.launched(lib, rc, "canonical_tables")
    return out
