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
value that atomic returned; the source note proves the counts exact.

K2 replaces histogram_pallas.py::order0_hist_pallas: a 256-bin copy per
warp, its walk about as fast as the bytes bound and its atomics the rest.

The output of both is zeroed here, as the kernels require.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]


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
    int32."""
    u = units.long()
    prev = torch.cat([torch.zeros((u.shape[0], 1), dtype=torch.long,
                                  device=u.device), u[:, :-1]], dim=1)
    pairs = (prev * 256 + u)[_valid(units, n_valid)]
    return torch.bincount(pairs, minlength=65536).to(
        torch.int32).reshape(256, 256)


def order0_hist_plain(units: torch.Tensor,
                      n_valid: torch.Tensor) -> torch.Tensor:
    """bincount of the valid bytes; (256,) int32."""
    return torch.bincount(units[_valid(units, n_valid)].long(),
                          minlength=256).to(torch.int32)


def _launch(fn_name: str, kernel: str, units: torch.Tensor,
            n_valid: torch.Tensor, shape: tuple) -> torch.Tensor:
    lib, fn = _build.load("histogram", fn_name, _ARGTYPES)
    out = torch.zeros(shape, dtype=torch.int32, device=units.device)
    R, n = units.shape
    if R * n == 0:
        return out
    rc = fn(units.data_ptr(), n_valid.data_ptr(), R, n, out.data_ptr(),
            _build.stream_ptr(units.device))
    _build.launched(lib, rc, kernel)
    return out


def markov_hist(units: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(R, n) uint8 units, (R,) int32 n_valid -> (256, 256) int32 counts.
    CPU tensors take the plain version; CUDA tensors launch K1."""
    if _check(units, n_valid) == "cpu":
        return markov_hist_plain(units, n_valid)
    return _launch("mhc_markov_hist", "markov_hist", units, n_valid,
                   (256, 256))


def order0_hist(units: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(R, n) uint8 units, (R,) int32 n_valid -> (256,) int32 counts.
    CPU tensors take the plain version; CUDA tensors launch K2."""
    if _check(units, n_valid) == "cpu":
        return order0_hist_plain(units, n_valid)
    return _launch("mhc_order0_hist", "order0_hist", units, n_valid, (256,))
