"""K1 and K2 — the Markov (prev, cur) and order-0 byte histograms: CUDA
kernel wrappers + plain versions.

Kernels: csrc/histogram.cu (sm_90a). Both read the input once, 16 bytes
per lane, over a one-wave grid whose blocks take equal shares of the flat
positions, and do one shared-memory atomic per byte.

K1 replaces mhc_tpu/ops/kernels/histogram_pallas.py::markov_hist_pallas.
It is bounded by its atomics, which return a value and so serialise where
a warp's pairs meet at one address. Every block holds the whole table as
65,536 16-bit counters, and lanes count the bytes of each word in rotated
orders, so equal pairs at one byte phase meet less. A counter that wraps
is credited to the global table by the atomic that wrapped it, from the
value that atomic returned; the source note proves the counts exact. Each
block stores its table to a row of a scratch that this wrapper allocates
(a row a streaming multiprocessor, 128 KB each), and a second kernel of
the same launch sums the rows into the output.

Both count into int64: a batch of 2**31 bytes or more can hold one cell
that often (2.25 GiB of zeros: 2,415,931,449 in cell (0, 0) and in byte
0), and the table build (`huffman_cuda.code_tables`) takes int64 counts.

K2 replaces histogram_pallas.py::order0_hist_pallas: a 256-bin copy per
warp, its walk about as fast as the bytes bound and its atomics the rest.

The output of both is zeroed here, as the kernels require.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.metrics import span
from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
_MARKOV_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_void_p]
# K1's blocks each store 256 * 256 16-bit fields (32,768 words) to the
# scratch
_K1_ROW_WORDS = 256 * 256 // 2


def _check(units: torch.Tensor, n_valid: torch.Tensor) -> str:
    dev = _build.require_cuda_or_cpu(units, n_valid)
    if units.dtype != torch.uint8 or units.dim() != 2:
        raise ValueError("units must be a (R, n) uint8 tensor")
    if n_valid.dtype != torch.int32 or n_valid.shape != units.shape[:1]:
        raise ValueError("n_valid must be a (R,) int32 tensor")
    if not (units.is_contiguous() and n_valid.is_contiguous()):
        raise ValueError("units and n_valid must be contiguous")
    return dev


def _valid(units: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    return (torch.arange(units.shape[1], device=units.device)[None, :]
            < n_valid.to(units.device)[:, None])


def markov_hist_plain(units: torch.Tensor,
                      n_valid: torch.Tensor) -> torch.Tensor:
    """bincount of prev*256+cur over the valid positions; (256, 256)
    int64."""
    u = units.long()
    prev = torch.cat([torch.zeros((u.shape[0], 1), dtype=torch.long,
                                  device=u.device), u[:, :-1]], dim=1)
    pairs = (prev * 256 + u)[_valid(units, n_valid)]
    return torch.bincount(pairs, minlength=65536).reshape(256, 256)


def order0_hist_plain(units: torch.Tensor,
                      n_valid: torch.Tensor) -> torch.Tensor:
    """bincount of the valid bytes; (256,) int64."""
    return torch.bincount(units[_valid(units, n_valid)].long(),
                          minlength=256)


def _launch(fn_name: str, kernel: str, units: torch.Tensor,
            n_valid: torch.Tensor, shape: tuple) -> torch.Tensor:
    markov = kernel == "markov_hist"
    lib, fn = _build.load("histogram", fn_name,
                          _MARKOV_ARGTYPES if markov else _ARGTYPES)
    out = torch.zeros(shape, dtype=torch.int64, device=units.device)
    R, n = units.shape
    if R * n == 0:
        return out
    scratch = ()
    if markov:
        rows = _build.sm_count(units.device)
        partial = torch.empty((rows, _K1_ROW_WORDS), dtype=torch.int32,
                              device=units.device)
        scratch = (partial.data_ptr(), rows)
    rc = fn(units.data_ptr(), n_valid.data_ptr(), R, n, out.data_ptr(),
            *scratch, _build.stream_ptr(units.device))
    _build.launched(lib, rc, kernel)
    return out


def markov_hist(units: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(R, n) uint8 units, (R,) int32 n_valid -> (256, 256) int64 counts.
    CPU tensors take the plain version; CUDA tensors launch K1."""
    with span("mhc.launch.markov_hist"):
        if _check(units, n_valid) == "cpu":
            return markov_hist_plain(units, n_valid)
        return _launch("mhc_markov_hist", "markov_hist", units, n_valid,
                       (256, 256))


def order0_hist(units: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(R, n) uint8 units, (R,) int32 n_valid -> (256,) int64 counts.
    CPU tensors take the plain version; CUDA tensors launch K2."""
    with span("mhc.launch.order0_hist"):
        if _check(units, n_valid) == "cpu":
            return order0_hist_plain(units, n_valid)
        return _launch("mhc_order0_hist", "order0_hist", units, n_valid,
                       (256,))
