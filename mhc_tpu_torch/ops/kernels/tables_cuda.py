"""K13 — canonical code tables from code lengths: CUDA kernel wrapper.

Kernel: csrc/tables.cu (sm_90a), one 256-thread block per output row,
around the table body it shares with the fused table build
(csrc/canonical.cuh; `huffman_cuda.code_tables`). It replaces
mhc_tpu/ops/canonical.py::canonical_codes, an XLA stage on the TPU; its
plain version is `ops/canonical.py::canonical_tables_plain`. It takes
uint8 lengths that no kernel has just computed (the decode's, uploaded
from the container; the host build's) and writes all six int32 tables in
one launch, order-0's 256 broadcast rows included. Launch-bound: under a
megabyte moved; `launch_floor` times an empty kernel on its grid.
"""

from __future__ import annotations

import ctypes

import torch

from .. import canonical
from ..huffman import MAX_CODE_LEN
from ...utils.metrics import span
from . import _build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = [_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P]
_FLOOR_ARGTYPES = [_I64, _P]
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
    with span("mhc.launch.canonical_tables"):
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
        out = empty_tables(rows, lengths.device)
        if rows:
            rc = fn(lengths.data_ptr(), lengths.shape[0], rows,
                    *(out[name].data_ptr() for name, _ in _LAYOUT),
                    _build.stream_ptr(lengths.device))
            _build.launched(lib, rc, "canonical_tables")
        return out


def empty_tables(rows: int, device) -> dict:
    """The six (rows, ...) int32 tables of `_LAYOUT`, uninitialised, as
    views of one buffer (one allocation), each contiguous: one
    `as_strided` a table, where a slice and a view would be two ops."""
    buf = torch.empty(rows * sum(w for _, w in _LAYOUT), dtype=torch.int32,
                      device=device)
    out, at = {}, 0
    for name, width in _LAYOUT:
        out[name] = buf.as_strided((rows, width), (width, 1), at)
        at += rows * width
    return out


def launch_floor(device) -> None:
    """Launch an empty kernel on K13's grid (256 blocks of 256 threads)
    on `device`'s current stream: the floor of K13's time, for its
    measurement. Off a CUDA device there is nothing to launch."""
    device = torch.device(device)
    if device.type == "cpu":
        return
    lib, fn = _build.load("tables", "mhc_launch_floor", _FLOOR_ARGTYPES)
    _build.launched(lib, fn(256, _build.stream_ptr(device)), "launch_floor")
