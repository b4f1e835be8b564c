"""K3 — fused (prev, cur) lookup + MSB-first pack: CUDA wrapper + plain
version.

Kernel: csrc/encode.cu (sm_90a), which replaces
mhc_tpu/ops/kernels/encode_pallas.py::pack_blocks_fused_sm. One thread
per unit with the canonical tables in shared memory; bounded by the
latency of each unit's serial bit chain (see the source note).
"""

from __future__ import annotations

import ctypes

import torch

from ..bitpack import words_for_block
from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_void_p]


def _check(units, n_valid, codes, lengths) -> str:
    dev = _build.require_cuda_or_cpu(units, n_valid, codes, lengths)
    if units.dtype != torch.uint8 or units.dim() != 2:
        raise ValueError("units must be a (R, n) uint8 tensor")
    if n_valid.dtype != torch.int32 or n_valid.shape != units.shape[:1]:
        raise ValueError("n_valid must be a (R,) int32 tensor")
    for name, t in (("codes", codes), ("lengths", lengths)):
        if t.dtype != torch.int32 or t.shape != (256, 256):
            raise ValueError(f"{name} must be a (256, 256) int32 tensor")
    if not (units.is_contiguous() and n_valid.is_contiguous()):
        raise ValueError("units and n_valid must be contiguous")
    return dev


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_units_plain(units, n_valid, codes, lengths):
    """Scatter-add form of `mhc_tpu.ops.bitpack.encode_blocks`: every
    symbol's bit offset from an exclusive prefix sum of its length; each
    code straddles at most two words, and disjoint bit ranges make add
    equal or."""
    u = units.long()
    R, n = u.shape
    dev = u.device
    W = words_for_block(n)
    prev = torch.cat([torch.zeros((R, 1), dtype=torch.long, device=dev),
                      u[:, :-1]], dim=1)
    idx = prev * 256 + u
    valid = (torch.arange(n, device=dev)[None, :]
             < n_valid.to(dev)[:, None])
    lens = torch.where(valid, lengths.reshape(-1).long()[idx], 0)
    cds = torch.where(valid, codes.reshape(-1).long()[idx], 0)
    offs = torch.cumsum(lens, dim=1) - lens
    total = offs[:, -1] + lens[:, -1]
    left = 32 - (offs & 31) - lens                  # in [-14, 32]
    part0 = torch.where(left >= 0, cds << left.clamp(0, 31),
                        cds >> (-left).clamp(0, 31))
    part1 = torch.where(left < 0,
                        (cds << (32 + left).clamp(0, 31)) & 0xFFFFFFFF, 0)
    w0 = offs >> 5
    words = torch.zeros((R, W + 1), dtype=torch.long, device=dev)
    words.scatter_add_(1, w0, part0)
    words.scatter_add_(1, w0 + 1, part1)
    return _to_i32(words[:, :W]), total.to(torch.int32)


def pack_units(units: torch.Tensor, n_valid: torch.Tensor,
               codes: torch.Tensor, lengths: torch.Tensor):
    """(R, n) uint8 units, (R,) int32 n_valid, (256, 256) int32 canonical
    codes and lengths -> (words (R, words_for_block(n)) int32 bit
    patterns, zero past each stream; bits (R,) int32). CPU tensors take
    the plain version; CUDA tensors launch K3."""
    if _check(units, n_valid, codes, lengths) == "cpu":
        return pack_units_plain(units, n_valid, codes, lengths)
    lib, fn = _build.load("encode", "mhc_pack_units", _ARGTYPES)
    R, n = units.shape
    W = words_for_block(n)
    dev = units.device
    words = torch.zeros((R, W), dtype=torch.int32, device=dev)
    bits = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0:
        return words, bits
    codes16 = codes.to(torch.int16).contiguous()    # codes < 2**15
    lens8 = lengths.to(torch.uint8).contiguous()
    rc = fn(units.data_ptr(), n_valid.data_ptr(), R, n, codes16.data_ptr(),
            lens8.data_ptr(), words.data_ptr(), W, bits.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(lib, rc, "pack_units launch")
    pack_units.launches += 1
    return words, bits


pack_units.launches = 0
