"""Canonical Huffman codes and O(1) decode tables from code lengths.

Counterpart of `mhc_tpu/ops/canonical.py::canonical_codes`, in plain
torch on whatever device the lengths live on. Codes are a pure function
of the lengths vector: prefix sums and one argsort, no tree. On a card
the engine's tables come from the fused table build on the encode
(`ops/kernels/huffman_cuda.py::code_tables`) and from K13
(`ops/kernels/tables_cuda.py`) on the decode; both share K13's body, and
`canonical_tables_plain` is its plain version.

Bit convention: MSB-first canonical codes (DEFLATE numbering). The
decoder peeks a fixed MAX_CODE_LEN-bit window `w` and resolves the code
length as 1 + #{l in 1..MAX_CODE_LEN-1 : w >= lim[l]}, where
    lim[l] = (first_code[l] + bl_count[l]) << (MAX_CODE_LEN - l),
then looks the symbol up by rank.
"""

from __future__ import annotations

import numpy as np
import torch

from .huffman import MAX_CODE_LEN


def canonical_codes(lengths: torch.Tensor,
                    max_len: int = MAX_CODE_LEN) -> dict:
    """Canonical codes + decode tables from lengths.

    lengths: (..., 256) integer tensor, 0 = absent symbol.
    Returns a dict of int32 tensors on lengths' device, batched over the
    leading dims:
      codes:       (..., 256)        canonical code (right-aligned)
      lengths:     (..., 256)        pass-through
      lim:         (..., max_len+1)  decode window limits, lim[0] = 0
      base:        (..., max_len+1)  rank base per length
      first_code:  (..., max_len+1)
      sorted_syms: (..., 256)        symbols ordered by (length, symbol)
    """
    lengths = lengths.to(torch.int64)
    dev = lengths.device
    n = lengths.shape[-1]
    ls = torch.arange(max_len + 1, device=dev)
    bl = (lengths[..., None] == ls).sum(dim=-2)
    bl[..., 0] = 0

    first = torch.zeros_like(bl)
    code = torch.zeros(lengths.shape[:-1], dtype=torch.int64, device=dev)
    for l in range(1, max_len + 1):
        code = (code + bl[..., l - 1]) << 1
        first[..., l] = code
    base = torch.cumsum(bl, dim=-1) - bl

    present = lengths > 0
    sortkey = (torch.where(present, lengths, max_len + 1) * n
               + torch.arange(n, device=dev))
    sorted_syms = torch.argsort(sortkey, dim=-1)
    global_rank = torch.argsort(sorted_syms, dim=-1)
    lens_cl = lengths.clamp(0, max_len)
    codes = (first.gather(-1, lens_cl) + global_rank
             - base.gather(-1, lens_cl))
    codes = torch.where(present, codes, 0)
    # limits left-aligned to the max_len-bit window; unpopulated lengths
    # repeat the previous boundary, so they are never selected
    lim = (first + bl) << (max_len - ls)
    lim[..., 0] = 0
    i32 = torch.int32
    return {
        "codes": codes.to(i32),
        "lengths": lengths.to(i32),
        "lim": lim.clamp(max=(1 << 31) - 1).to(i32),
        "base": base.to(i32),
        "first_code": first.to(i32),
        "sorted_syms": sorted_syms.to(i32),
    }


def canonical_tables_plain(lengths: torch.Tensor, rows: int) -> dict:
    """K13's plain version: `canonical_codes` of (L, 256) lengths as
    (rows, ...) tables, each contiguous; L is `rows`, or 1 and its tables
    repeated over the rows (order-0's single table, broadcast over the
    256 contexts the kernels index)."""
    t = canonical_codes(lengths)
    if lengths.shape[0] == rows:
        return t
    return {k: v.expand(rows, v.shape[-1]).contiguous() for k, v in t.items()}


def canonical_codes_host(lengths: np.ndarray,
                         max_len: int = MAX_CODE_LEN) -> dict:
    """canonical_codes on host numpy lengths, returning numpy arrays (the
    container's metadata codecs)."""
    t = canonical_codes(torch.from_numpy(np.asarray(lengths, np.int64)),
                        max_len)
    return {k: v.numpy() for k, v in t.items()}
