"""K7 — canonical Huffman decode, Markov (K7m) and order-0 (K7o): CUDA
wrapper + plain version.

Kernel: csrc/decode.cu (sm_90a), which replaces
mhc_tpu/ops/kernels/decode_pallas.py::decode_blocks_pallas, both its
Markov and its order-0 call. One thread per unit stream with the decode
tables in shared memory (every context's for Markov, context 0's alone
for order-0); bounded by the latency of each unit's serial symbol chain
(see the source note).
"""

from __future__ import annotations

import ctypes

import torch

from ..huffman import MAX_CODE_LEN
from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int, ctypes.c_void_p]
_L = MAX_CODE_LEN + 1


def _check(words, n_valid, lim, base, first_code, sorted_syms) -> str:
    dev = _build.require_cuda_or_cpu(words, n_valid, lim, base,
                                     first_code, sorted_syms)
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError("words must be a (R, W) int32 tensor")
    if n_valid.dtype != torch.int32 or n_valid.shape != words.shape[:1]:
        raise ValueError("n_valid must be a (R,) int32 tensor")
    for name, t, shape in (("lim", lim, (256, _L)), ("base", base, (256, _L)),
                           ("first_code", first_code, (256, _L)),
                           ("sorted_syms", sorted_syms, (256, 256))):
        if t.dtype != torch.int32 or t.shape != shape:
            raise ValueError(f"{name} must be a {shape} int32 tensor")
    if not (words.is_contiguous() and n_valid.is_contiguous()):
        raise ValueError("words and n_valid must be contiguous")
    return dev


def decode_units_plain(words, n_valid, lim, base, first_code, sorted_syms,
                       n_out: int, markov: bool = True) -> torch.Tensor:
    """`mhc_tpu.ops.bitpack.decode_blocks` in torch: a Python loop over
    the symbol steps, vectorised over units. Words past W read as 0; with
    markov=False the context stays 0."""
    R, W = words.shape
    dev = words.device
    w64 = torch.zeros((R, W + 2), dtype=torch.long, device=dev)
    w64[:, :W] = words.long() & 0xFFFFFFFF
    lim64 = lim.long()
    bf = (base - first_code).long()
    ss = sorted_syms.long()
    nv = n_valid.long().clamp(0, n_out)
    rows = torch.arange(R, device=dev)
    bitpos = torch.zeros(R, dtype=torch.long, device=dev)
    ctx = torch.zeros(R, dtype=torch.long, device=dev)
    out = torch.zeros((R, n_out), dtype=torch.uint8, device=dev)
    steps = int(nv.max()) if R else 0
    for t in range(steps):
        w = (bitpos >> 5).clamp(max=W)
        s = bitpos & 31
        hi = (w64[rows, w] << s) & 0xFFFFFFFF
        lo = w64[rows, w + 1] >> (32 - s)
        window = (hi | lo) >> (32 - MAX_CODE_LEN)
        ge = window[:, None] >= lim64[ctx, 1:MAX_CODE_LEN]
        length = 1 + ge.sum(dim=1)
        code = window >> (MAX_CODE_LEN - length)
        sym = ss[ctx, (bf[ctx, length] + code).clamp(0, 255)]
        valid = t < nv
        bitpos += torch.where(valid, length, 0)
        if markov:
            ctx = torch.where(valid, sym, ctx)
        out[:, t] = torch.where(valid, sym, 0).to(torch.uint8)
    return out


def decode_units(words: torch.Tensor, n_valid: torch.Tensor,
                 lim: torch.Tensor, base: torch.Tensor,
                 first_code: torch.Tensor, sorted_syms: torch.Tensor,
                 n_out: int, markov: bool = True) -> torch.Tensor:
    """(R, W) int32 MSB-first streams, (R,) int32 symbol counts and the
    canonical decode tables -> (R, n_out) uint8, zero past n_valid; the
    context is the previous symbol (markov) or 0 throughout (order-0,
    which reads only row 0 of each table). CPU tensors take the plain
    version; CUDA tensors launch K7m or K7o."""
    if _check(words, n_valid, lim, base, first_code, sorted_syms) == "cpu":
        return decode_units_plain(words, n_valid, lim, base, first_code,
                                  sorted_syms, n_out, markov)
    lib, fn = _build.load("decode", "mhc_decode_units", _ARGTYPES)
    R, W = words.shape
    dev = words.device
    out = torch.empty((R, n_out), dtype=torch.uint8, device=dev)
    if R * n_out == 0:
        return out
    lim_c = lim.contiguous()                       # values <= 2**15
    bf = (base - first_code).contiguous()
    syms8 = sorted_syms.to(torch.uint8).contiguous()
    rc = fn(words.data_ptr(), R, W, n_valid.data_ptr(), lim_c.data_ptr(),
            bf.data_ptr(), syms8.data_ptr(), out.data_ptr(), n_out,
            int(markov), _build.stream_ptr(dev))
    _build.launched(lib, rc,
                    "decode_units" if markov else "decode_units_order0")
    return out
