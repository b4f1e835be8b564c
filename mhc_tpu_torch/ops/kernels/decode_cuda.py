"""K7 — canonical Huffman decode, Markov (K7m) and order-0 (K7o), and
the build of its decode table: CUDA wrappers + plain versions.

Kernels: csrc/decode.cu (sm_90a), which replaces
mhc_tpu/ops/kernels/decode_pallas.py::decode_blocks_pallas, both its
Markov and its order-0 call. `decode_lut` builds the table the decode
kernel holds in shared memory: for order-0 a direct (sym, len) table
over the 15-bit window (65,536 B); for Markov a per-context root table
over the next 7 bits with an escape mark for longer codes, the sorted
symbols and the escape rows (143,360 B).

One thread per unit stream. While the chains are few, each unit's
serial symbol chain bounds it (~200 cycles a symbol on the H100 against
~60 instructions; see the source note). `layout` sizes the launch from
the units and the SM count: a block an SM, threads sized to the units,
up to 512 for Markov (four chains a scheduler) and 1,024 for order-0,
each with a 132 B word ring beside the table in the block's 232,448 B
of shared memory (Markov at 512: 210,944 B). At 12,800 units (100 MB of
8 KB units) that is 128 threads a block, one round of at most one chain
a scheduler, the chain's latency times the symbols a unit; up to 16,896
units (132 SMs x 128) no block takes more than 128 threads. At 294,914
units (2.4 GB) it is 512 threads, 4.4 rounds of four chains a
scheduler, where 128 threads would run 18 rounds of one, and issue,
not the chain, binds a round. `LAYOUTS` counts the launches by their
threads a block.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..huffman import MAX_CODE_LEN
from ...utils.metrics import span
from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_ARGTYPES = [_P, _I64, _I64, _P, _P, _P, _I64, _I, _I, _I, _P]
_LUT_ARGTYPES = [_P, _P, _P, _P, _I, _P, _P]
_L = MAX_CODE_LEN + 1
# the decode table's layout (csrc/decode.cu): root windows; the Markov
# escape row packs lim[8..14] and a 0x8000 pad (4 words), then base -
# first_code at 8..15 (4 words), as 16-bit halves, then 4 words of zeros
ROOT_BITS = {True: 7, False: MAX_CODE_LEN}
ESC_FIRST = ROOT_BITS[True] + 1
ESC_STRIDE = 12
# the launch: threads a block at most, each with its word ring (33 words)
# beside the table in the shared memory a block may have
MAX_THREADS = {True: 512, False: 1024}
RING_BYTES = 33 * 4
SMEM_BYTES = 232_448

# K7 launches by threads a block (one block an SM: the chains in flight
# on each SM) since the last `LAYOUTS.clear()`; read by no metric
LAYOUTS: collections.Counter = collections.Counter()


def _check_tables(lim, base, first_code, sorted_syms) -> None:
    for name, t, shape in (("lim", lim, (256, _L)), ("base", base, (256, _L)),
                           ("first_code", first_code, (256, _L)),
                           ("sorted_syms", sorted_syms, (256, 256))):
        if t.dtype != torch.int32 or t.shape != shape:
            raise ValueError(f"{name} must be a {shape} int32 tensor")


def _check(words, n_valid, lim, base, first_code, sorted_syms) -> str:
    dev = _build.require_cuda_or_cpu(words, n_valid, lim, base,
                                     first_code, sorted_syms)
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError("words must be a (R, W) int32 tensor")
    if n_valid.dtype != torch.int32 or n_valid.shape != words.shape[:1]:
        raise ValueError("n_valid must be a (R,) int32 tensor")
    _check_tables(lim, base, first_code, sorted_syms)
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


def lut_bytes(markov: bool) -> int:
    """Bytes of the decode table: the Markov root (256 x 128 u16), u8
    sorted symbols and escape rows (256 x ESC_STRIDE int32); or the
    order-0 direct table (2**15 u16)."""
    if markov:
        return (256 * (2 << ROOT_BITS[True]) + 256 * 256
                + 256 * ESC_STRIDE * 4)
    return 2 << MAX_CODE_LEN


def split_lut(lut: torch.Tensor, markov: bool = True):
    """A decode table's parts, `decode_lut_plain`'s layout read back:
    (root, syms8, esc_lim, esc_bf). root: (rows, 2**ROOT_BITS) int16
    entries sym | len << 8 (0: escape), rows 256 for Markov, 1 for
    order-0. Markov also has the sorted symbols, (256, 256) uint8, and
    the escape rows unpacked to int64 lim[ESC_FIRST..14] and
    bf[ESC_FIRST..15]; order-0 has None for all three."""
    rows = 256 if markov else 1
    n_root = 2 * rows << ROOT_BITS[markov]
    root = lut[:n_root].view(torch.int16).reshape(rows, -1)
    if not markov:
        return root, None, None, None
    syms8 = lut[n_root: n_root + 256 * 256].reshape(256, 256)
    words = (lut[n_root + 256 * 256:].view(torch.int32)
             .reshape(256, 3, ESC_STRIDE // 3).long() & 0xFFFFFFFF)
    lims, bf, _ = torch.stack([words & 0xFFFF, words >> 16], dim=3
                              ).reshape(256, 3, -1).unbind(1)
    return (root, syms8, lims[:, :MAX_CODE_LEN - ESC_FIRST],
            torch.where(bf >= 1 << 15, bf - (1 << 16), bf))


def decode_lut_plain(lim, base, first_code, sorted_syms,
                     markov: bool = True) -> torch.Tensor:
    """The decode kernel's shared-memory table as uint8 bytes. Entry
    (row, i) takes the window w = i << (15 - bits) and gives the
    contract's len = 1 + #{l in 1..14 : w >= lim[row][l]} and sym =
    sorted_syms[row][clamp(bf[row][len] + (w >> (15 - len)), 0, 255)]
    (bf = base - first_code) as sym | len << 8 when len <= bits, else 0;
    bits is 7 (Markov, every context) or 15 (order-0, row 0 alone).
    Markov appends the sorted symbols as u8 and each context's escape
    row of ESC_STRIDE int32 words: lim[8..14] clamped to 0x8000 and a pad
    of 0x8000, then bf[8..15] clamped to int16, two 16-bit halves a word
    (low half first), then zero words. A window is below 2**15, so
    neither clamp changes a compare or a clamped symbol index, and the
    pad never counts."""
    bits = ROOT_BITS[markov]
    rows = 256 if markov else 1
    lim64 = lim[:rows].long()
    bf = (base[:rows] - first_code[:rows]).long()
    w = (torch.arange(1 << bits, device=lim.device)
         << (MAX_CODE_LEN - bits))
    length = 1 + (w[None, :, None] >= lim64[:, None, 1:MAX_CODE_LEN]).sum(-1)
    idx = (bf.gather(1, length) + (w[None, :] >> (MAX_CODE_LEN - length))
           ).clamp(0, 255)
    sym = sorted_syms[:rows].long().gather(1, idx)
    root = torch.where(length <= bits, sym | length << 8, 0)
    parts = [root.to(torch.int16).reshape(-1).view(torch.uint8)]
    if markov:
        halves = torch.cat([
            lim64[:, ESC_FIRST:MAX_CODE_LEN].clamp(max=0x8000),
            torch.full_like(bf[:, :1], 0x8000),
            bf[:, ESC_FIRST:].clamp(-(1 << 15), (1 << 15) - 1) & 0xFFFF],
            dim=1)
        esc = halves[:, 0::2] | halves[:, 1::2] << 16
        esc = torch.cat([esc, torch.zeros_like(
            esc[:, :ESC_STRIDE - esc.shape[1]])], dim=1)
        esc = torch.where(esc >= 1 << 31, esc - (1 << 32), esc)
        parts += [sorted_syms.to(torch.uint8).reshape(-1),
                  esc.to(torch.int32).reshape(-1).view(torch.uint8)]
    return torch.cat(parts)


def decode_lut(lim: torch.Tensor, base: torch.Tensor,
               first_code: torch.Tensor, sorted_syms: torch.Tensor,
               markov: bool = True) -> torch.Tensor:
    """The canonical decode tables -> the decode kernel's table
    (`decode_lut_plain`'s bytes). CPU tensors take the plain version;
    CUDA tensors launch the build kernel."""
    kernel = "decode_lut" if markov else "decode_lut_order0"
    with span("mhc.launch." + kernel):
        kind = _build.require_cuda_or_cpu(lim, base, first_code, sorted_syms)
        _check_tables(lim, base, first_code, sorted_syms)
        if kind == "cpu":
            return decode_lut_plain(lim, base, first_code, sorted_syms, markov)
        lib, fn = _build.load("decode", "mhc_decode_lut", _LUT_ARGTYPES)
        dev = lim.device
        lut = torch.empty((lut_bytes(markov),), dtype=torch.uint8,
                          device=dev)
        rc = fn(lim.contiguous().data_ptr(), base.contiguous().data_ptr(),
                first_code.contiguous().data_ptr(),
                sorted_syms.contiguous().data_ptr(), int(markov),
                lut.data_ptr(), _build.stream_ptr(dev))
        _build.launched(lib, rc, kernel)
        return lut


def layout(R: int, sms: int, markov: bool = True) -> tuple[int, int]:
    """(blocks, threads) of a K7 launch over R >= 1 units on `sms` SMs:
    a block an SM at most (the table fills most of its shared memory),
    its threads the units a block rounded up to a warp, at most
    MAX_THREADS[markov]; units beyond blocks * threads are strided over
    the blocks. So the launch keeps as many chains in flight as the
    units fill, and at most 128 threads a block up to R = sms * 128."""
    blocks = min(sms, R)
    per = -(-R // blocks)
    return blocks, min(MAX_THREADS[markov], -(-per // 32) * 32)


def decode_units(words: torch.Tensor, n_valid: torch.Tensor,
                 lim: torch.Tensor, base: torch.Tensor,
                 first_code: torch.Tensor, sorted_syms: torch.Tensor,
                 n_out: int, markov: bool = True) -> torch.Tensor:
    """(R, W) int32 MSB-first streams, (R,) int32 symbol counts and the
    canonical decode tables -> (R, n_out) uint8, zero past n_valid; the
    context is the previous symbol (markov) or 0 throughout (order-0,
    which reads only row 0 of each table). CPU tensors take the plain
    version; CUDA tensors build the decode table (`decode_lut`) and
    launch K7m or K7o in `layout`'s shape."""
    kernel = "decode_units" if markov else "decode_units_order0"
    with span("mhc.launch." + kernel):
        if _check(words, n_valid, lim, base, first_code, sorted_syms) == "cpu":
            return decode_units_plain(words, n_valid, lim, base, first_code,
                                      sorted_syms, n_out, markov)
        R, W = words.shape
        dev = words.device
        out = torch.empty((R, n_out), dtype=torch.uint8, device=dev)
        if R * n_out == 0:
            return out
        lut = decode_lut(lim, base, first_code, sorted_syms, markov)
        blocks, threads = layout(R, _build.sm_count(dev), markov)
        lib, fn = _build.load("decode", "mhc_decode_units", _ARGTYPES)
        rc = fn(words.data_ptr(), R, W, n_valid.data_ptr(), lut.data_ptr(),
                out.data_ptr(), n_out, int(markov), blocks, threads,
                _build.stream_ptr(dev))
        _build.launched(lib, rc, kernel)
        LAYOUTS[threads] += 1
        return out
