"""The encode kernels: CUDA wrappers + plain versions.

- K3 `pack_units`: fused (prev, cur) lookup + MSB-first pack; replaces
  mhc_tpu/ops/kernels/encode_pallas.py::pack_blocks_fused_sm.
- K5 `lookup_cl`: the cl plane (len << 16 | code per symbol, 0 past
  n_valid); replaces mhc_tpu/ops/kernels/lookup_pallas.py::
  lookup_cl_sm_pallas, unit-major here.
- K4 `pack_cl`: MSB-first pack of a cl plane; replaces
  encode_pallas.py::pack_blocks_dense.
- K6 `bubble_pack`: the bubble-stream pack of a cl plane, one (word,
  valid) slot per round of two codes; replaces
  encode_pallas.py::_run_bubble_pack. `ops/bitpack.py` compacts its output.

All four live in csrc/encode.cu (sm_90a). K4(K5(x)) equals K3(x) word
for word, and so do K6's compacted words; the plain versions are
composed the same way. K3 splits each unit over a warp (per-lane chunks,
a warp scan of their bit counts, then each lane packs from its offset);
K4 and K6 are one tile packer, a warp per unit walking the cl row in
tiles of 128 symbols (a warp scan of the lanes' bit counts, the bits
ORed into stream words staged in shared memory, K6's slots read back
from those words); K4, K5 and K6 are bounded by device-memory bandwidth
(see the source note).
"""

from __future__ import annotations

import ctypes

import torch

from ..bitpack import words_for_block
from ...utils.metrics import span
from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int64
_PACK_ARGTYPES = [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P]
_LOOKUP_ARGTYPES = [_P, _P, _I, _I, _P, _P, _P, _P]
_PACK_CL_ARGTYPES = [_P, _I, _I, _P, _I, _P, _P]
_BUBBLE_ARGTYPES = [_P, _I, _I, _P, _P, _P, _P, _P]


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


def _check_cl(cl) -> str:
    dev = _build.require_cuda_or_cpu(cl)
    if cl.dtype != torch.int32 or cl.dim() != 2 or not cl.is_contiguous():
        raise ValueError("cl must be a contiguous (R, n) int32 tensor")
    return dev


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _tables(codes, lengths):
    """The kernels' table layout: u16 codes (< 2**15) and u8 lengths."""
    return (codes.to(torch.int16).contiguous(),
            lengths.to(torch.uint8).contiguous())


def lookup_cl_plain(units, n_valid, codes, lengths) -> torch.Tensor:
    """(R, n) int32 cl = lengths[prev, cur] << 16 | codes[prev, cur],
    prev the unit's previous byte (0 at j = 0), 0 past n_valid."""
    u = units.long()
    R, n = u.shape
    dev = u.device
    prev = torch.cat([torch.zeros((R, 1), dtype=torch.long, device=dev),
                      u[:, :-1]], dim=1)
    idx = prev * 256 + u
    cl = ((lengths.reshape(-1).long()[idx] << 16)
          | codes.reshape(-1).long()[idx])
    valid = (torch.arange(n, device=dev)[None, :]
             < n_valid.to(dev)[:, None])
    return torch.where(valid, cl, 0).to(torch.int32)


def pack_cl_plain(cl: torch.Tensor):
    """Scatter-add form of `mhc_tpu.ops.bitpack.encode_blocks`: every
    symbol's bit offset from an exclusive prefix sum of its length; each
    code straddles at most two words, and disjoint bit ranges make add
    equal or."""
    R, n = cl.shape
    dev = cl.device
    W = words_for_block(n)
    c = cl.long()
    lens = c >> 16
    cds = c & 0xFFFF
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


def bubble_pack_plain(cl: torch.Tensor):
    """K6's contract without a loop over rounds. With S_r a unit's bits
    after round r (a cumsum of pairwise lengths), round r completes word
    S_{r-1} >> 5 of pack_cl_plain's stream iff S_r >> 5 exceeds it; at a
    round that completes none, the slot holds word S_r >> 5 cut to its top
    S_r & 31 bits (the pending bits), and the tail is that word at the
    stream's end."""
    R, n = cl.shape
    rounds = (n + 1) // 2
    words, total = pack_cl_plain(cl)
    w = words.long() & 0xFFFFFFFF
    lens = cl.long() >> 16
    if n % 2:
        lens = torch.cat([lens, torch.zeros_like(lens[:, :1])], dim=1)
    pair = lens.reshape(R, rounds, 2).sum(-1)
    after = torch.cumsum(pair, dim=1)
    before = after - pair
    bv = (after >> 5) - (before >> 5)

    def pending(s):
        cut = 32 - (s & 31)
        return (w.gather(1, s >> 5) >> cut) << cut

    bw = torch.where(bv > 0, w.gather(1, before >> 5), pending(after))
    tail = pending(total.long()[:, None])[:, 0]
    return _to_i32(bw), bv.to(torch.uint8), _to_i32(tail), total


def pack_units_plain(units, n_valid, codes, lengths):
    """K3's contract as K5 then K4, in plain torch."""
    return pack_cl_plain(lookup_cl_plain(units, n_valid, codes, lengths))


def pack_units(units: torch.Tensor, n_valid: torch.Tensor,
               codes: torch.Tensor, lengths: torch.Tensor):
    """(R, n) uint8 units, (R,) int32 n_valid, (256, 256) int32 canonical
    codes and lengths -> (words (R, words_for_block(n)) int32 bit
    patterns, zero past each stream; bits (R,) int32). CPU tensors take
    the plain version; CUDA tensors launch K3."""
    with span("mhc.launch.pack_units"):
        if _check(units, n_valid, codes, lengths) == "cpu":
            return pack_units_plain(units, n_valid, codes, lengths)
        lib, fn = _build.load("encode", "mhc_pack_units", _PACK_ARGTYPES)
        R, n = units.shape
        W = words_for_block(n)
        dev = units.device
        words = torch.zeros((R, W), dtype=torch.int32, device=dev)
        bits = torch.empty((R,), dtype=torch.int32, device=dev)
        if R == 0:
            return words, bits
        codes16, lens8 = _tables(codes, lengths)
        rc = fn(units.data_ptr(), n_valid.data_ptr(), R, n, codes16.data_ptr(),
                lens8.data_ptr(), words.data_ptr(), W, bits.data_ptr(),
                _build.stream_ptr(dev))
        _build.launched(lib, rc, "pack_units")
        return words, bits


def lookup_cl(units: torch.Tensor, n_valid: torch.Tensor,
              codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(R, n) uint8 units, (R,) int32 n_valid, (256, 256) int32 canonical
    codes and lengths -> (R, n) int32 cl plane, 0 past n_valid. CPU
    tensors take the plain version; CUDA tensors launch K5."""
    with span("mhc.launch.lookup_cl"):
        if _check(units, n_valid, codes, lengths) == "cpu":
            return lookup_cl_plain(units, n_valid, codes, lengths)
        lib, fn = _build.load("encode", "mhc_lookup_cl", _LOOKUP_ARGTYPES)
        R, n = units.shape
        dev = units.device
        cl = torch.empty((R, n), dtype=torch.int32, device=dev)
        if R * n == 0:
            return cl
        codes16, lens8 = _tables(codes, lengths)
        rc = fn(units.data_ptr(), n_valid.data_ptr(), R, n, codes16.data_ptr(),
                lens8.data_ptr(), cl.data_ptr(), _build.stream_ptr(dev))
        _build.launched(lib, rc, "lookup_cl")
        return cl


def pack_cl(cl: torch.Tensor):
    """(R, n) int32 cl plane -> (words (R, words_for_block(n)) int32 bit
    patterns, zero past each stream; bits (R,) int32). CPU tensors take
    the plain version; CUDA tensors launch K4."""
    with span("mhc.launch.pack_cl"):
        if _check_cl(cl) == "cpu":
            return pack_cl_plain(cl)
        lib, fn = _build.load("encode", "mhc_pack_cl", _PACK_CL_ARGTYPES)
        R, n = cl.shape
        W = words_for_block(n)
        dev = cl.device
        words = torch.zeros((R, W), dtype=torch.int32, device=dev)
        bits = torch.empty((R,), dtype=torch.int32, device=dev)
        if R == 0:
            return words, bits
        rc = fn(cl.data_ptr(), R, n, words.data_ptr(), W, bits.data_ptr(),
                _build.stream_ptr(dev))
        _build.launched(lib, rc, "pack_cl")
        return words, bits


def bubble_pack(cl: torch.Tensor):
    """(R, n) int32 cl plane -> (bw (R, ceil(n/2)) int32 bit patterns, bv
    (R, ceil(n/2)) uint8 0/1, tail (R,) int32, bits (R,) int32): slot r of
    a unit is the word its round r (codes 2r and 2r + 1) completes, with
    bv 1, or else its pending bits MSB-aligned, with bv 0; tail is the
    pending bits after the last round, bits the stream's length; bw and
    bv are contiguous, unit-major. CPU tensors take the plain version;
    CUDA tensors launch K6."""
    with span("mhc.launch.bubble_pack"):
        if _check_cl(cl) == "cpu":
            return bubble_pack_plain(cl)
        lib, fn = _build.load("encode", "mhc_bubble_pack", _BUBBLE_ARGTYPES)
        R, n = cl.shape
        rounds = (n + 1) // 2
        dev = cl.device
        # the kernel writes every element
        bw = torch.empty((R, rounds), dtype=torch.int32, device=dev)
        bv = torch.empty((R, rounds), dtype=torch.uint8, device=dev)
        tail = torch.empty((R,), dtype=torch.int32, device=dev)
        bits = torch.empty((R,), dtype=torch.int32, device=dev)
        if R == 0:
            return bw, bv, tail, bits
        rc = fn(cl.data_ptr(), R, n, bw.data_ptr(), bv.data_ptr(),
                tail.data_ptr(), bits.data_ptr(), _build.stream_ptr(dev))
        _build.launched(lib, rc, "bubble_pack")
        return bw, bv, tail, bits
