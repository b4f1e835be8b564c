"""K10+K8, K9/K12, K14 and K15 — the unit-stream stages of the engine's
encode and decode: CUDA kernel wrappers.

Kernels: csrc/stages.cu (sm_90a), one block per unit (K14: per literal
row). They replace the XLA stages of mhc_tpu/ops/bitpack.py and of
mhc_tpu/ops/kernels/encode_pallas.py:
  compact_units (K10+K8): substitute_raw_units (:178), then
    device_compact_words_slices (:509) / device_compact_words (:442);
  expand_units (K9/K12): device_expand_words_slices (:480) /
    device_expand_words_u32 (:467), and device_expand_words (:652);
  literal_rows (K14): words_to_unit_bytes (:221) with the jnp.where of
    mhc_tpu/engine.py:495 and mhc_tpu/api.py:587;
  compact_bubbles (K15): encode_pallas.py::compact_bubbles (:514) and
    the compaction in pack_blocks_pallas (:417), K6's bubble stream to
    (R, W) rows;
  bubbles_to_payload (K15): encode_pallas.py::pack_blocks_to_payload
    (:453), K6's bubble stream straight to the dense payload, the word
    offsets scanned on the card.
Their plain versions are `ops/bitpack.py::compact_units_plain`,
`expand_units_plain`, `literal_rows_plain`, `compact_bubbles` and
`bubbles_to_payload`, with the same arguments.
Each is bound by the bytes it copies (the source note has the design).
"""

from __future__ import annotations

import ctypes

import torch

from .. import bitpack
from ...utils.metrics import span
from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_COMPACT_ARGTYPES = [_P, _I64, _I64, _I64, _P, _I64, _I, _P, _P, _P, _P,
                     _P]
_EXPAND_ARGTYPES = [_P, _I64, _I, _P, _I64, _I64, _P, _P]
_LITERAL_ARGTYPES = [_P, _I64, _I64, _P, _I64, _I64, _P, _P]
_BUBBLES_ARGTYPES = [_P, _P, _P, _P, _I64, _I64, _I64, _P, _P]
_PAYLOAD_ARGTYPES = [_P, _P, _P, _P, _I64, _I64, _P, _P, _P]


def _require(t: torch.Tensor, name: str, dtypes, shape) -> None:
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
        kinds = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name} must be a {tuple(shape)} {kinds} tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def compact_units(words: torch.Tensor, units: torch.Tensor,
                  n_valid: torch.Tensor, word_offsets: torch.Tensor,
                  literal: torch.Tensor, total: int) -> torch.Tensor:
    """(R, W) int32 coded rows (rows of a wider plane too: the words of a
    row contiguous), (R, du) uint8 units, (R,) int32 n_valid,
    (R + 1,) int64 word offsets (the total last) and (R,) bool or uint8
    literal flags, all from the host's bit counts -> the (total,) int32
    dense payload: unit r's words at word_offsets[r], its coded row's or,
    for a literal unit, its n_valid bytes as big-endian words. CPU
    tensors take the plain version; CUDA tensors launch K10+K8."""
    with span("mhc.launch.compact_units"):
        dev = _build.require_cuda_or_cpu(words, units, n_valid, word_offsets,
                                         literal)
        if words.dim() != 2 or units.dim() != 2:
            raise ValueError("words and units must be 2-D")
        R, W = words.shape
        du = units.shape[1]
        if words.dtype != torch.int32 or (W > 1 and words.stride(1) != 1):
            raise ValueError("words must be an (R, W) int32 tensor whose rows "
                             "are contiguous")
        _require(units, "units", (torch.uint8,), (R, du))
        _require(n_valid, "n_valid", (torch.int32,), (R,))
        _require(word_offsets, "word_offsets", (torch.int64,), (R + 1,))
        _require(literal, "literal", (torch.bool, torch.uint8), (R,))
        if W < du // 4:
            raise ValueError(f"stream width {W} cannot hold a {du}-byte "
                             "literal unit")
        if dev == "cpu":
            return bitpack.compact_units_plain(words, units, n_valid,
                                               word_offsets, literal, total)
        lib, fn = _build.load("stages", "mhc_compact_units", _COMPACT_ARGTYPES)
        out = torch.empty((total,), dtype=torch.int32, device=words.device)
        if R == 0 or total == 0:
            return out
        vec4 = int(du % 4 == 0 and units.data_ptr() % 4 == 0)
        rc = fn(words.data_ptr(), R, W, max(words.stride(0), W),
                units.data_ptr(), du, vec4,
                n_valid.data_ptr(), word_offsets.data_ptr(),
                literal.data_ptr(), out.data_ptr(),
                _build.stream_ptr(words.device))
        _build.launched(lib, rc, "compact_units")
        return out


def expand_units(payload: torch.Tensor, offsets: torch.Tensor,
                 W: int) -> torch.Tensor:
    """(T,) payload, int32 words (the word-aligned layout) or uint8 bytes
    (the unaligned order-0 container), and (R + 1,) int64 offsets into it
    in its elements (the total last) -> (R, W) int32 zero-padded
    big-endian stream rows. CPU tensors take the plain version; CUDA
    tensors launch K9 (words) or K12 (bytes), one kernel."""
    with span("mhc.launch.expand_units"):
        dev = _build.require_cuda_or_cpu(payload, offsets)
        if payload.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 1:
            raise ValueError("payload must be 1-D and offsets (R + 1,)")
        _require(payload, "payload", (torch.int32, torch.uint8), payload.shape)
        _require(offsets, "offsets", (torch.int64,), offsets.shape)
        if W < 0:
            raise ValueError(f"row width {W} < 0")
        if dev == "cpu":
            return bitpack.expand_units_plain(payload, offsets, W)
        lib, fn = _build.load("stages", "mhc_expand_units", _EXPAND_ARGTYPES)
        R = offsets.numel() - 1
        out = torch.empty((R, W), dtype=torch.int32, device=payload.device)
        if R * W == 0:
            return out
        rc = fn(payload.data_ptr(), payload.numel(),
                int(payload.dtype == torch.uint8), offsets.data_ptr(), R, W,
                out.data_ptr(), _build.stream_ptr(payload.device))
        _build.launched(lib, rc, "expand_units")
        return out


def literal_rows(out: torch.Tensor, words: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """The decoded (R, du) uint8 rows `out`, with du % 4 == 0, its
    literal rows `rows` ((n,) int64) overwritten in place with the
    big-endian bytes of their (R, W) int32 stream words (zero past W
    words); returns `out`. Runs after the decode kernel, which zeroes
    the rows it skips. CPU tensors take the plain version; CUDA tensors
    launch K14 over the literal rows alone."""
    with span("mhc.launch.literal_rows"):
        dev = _build.require_cuda_or_cpu(out, words, rows)
        if out.dim() != 2 or words.dim() != 2 or rows.dim() != 1:
            raise ValueError("out and words must be 2-D, rows 1-D")
        R, du = out.shape
        _require(out, "out", (torch.uint8,), (R, du))
        _require(words, "words", (torch.int32,), (R, words.shape[1]))
        _require(rows, "rows", (torch.int64,), rows.shape)
        if du % 4:
            raise ValueError(f"literal rows of {du} bytes: not whole words")
        if dev == "cpu":
            return bitpack.literal_rows_plain(out, words, rows)
        lib, fn = _build.load("stages", "mhc_literal_rows", _LITERAL_ARGTYPES)
        if rows.numel() == 0:
            return out
        if out.data_ptr() % 4:
            raise ValueError("out must be 4-byte aligned")
        rc = fn(words.data_ptr(), R, words.shape[1], rows.data_ptr(),
                rows.numel(), du, out.data_ptr(),
                _build.stream_ptr(out.device))
        _build.launched(lib, rc, "literal_rows")
        return out


def _check_bubbles(bw, bv, tail, bits) -> str:
    dev = _build.require_cuda_or_cpu(bw, bv, tail, bits)
    if bw.dim() != 2:
        raise ValueError("bw must be 2-D")
    R, rounds = bw.shape
    _require(bw, "bw", (torch.int32,), (R, rounds))
    _require(bv, "bv", (torch.uint8,), (R, rounds))
    _require(tail, "tail", (torch.int32,), (R,))
    _require(bits, "bits", (torch.int32,), (R,))
    return dev


def compact_bubbles(bw: torch.Tensor, bv: torch.Tensor, tail: torch.Tensor,
                    bits: torch.Tensor, W: int) -> torch.Tensor:
    """K6's bubble stream, (R, rounds) int32 words and uint8 0/1 flags
    and (R,) int32 tail and bits, each unit's valid slots at most W ->
    (R, W) int32 rows: the k-th valid word of a unit at word k, the tail
    at word bits >> 5 where bits % 32 != 0, zero past the stream. CPU
    tensors take the plain version; CUDA tensors launch K15."""
    with span("mhc.launch.compact_bubbles"):
        dev = _check_bubbles(bw, bv, tail, bits)
        if W < 0:
            raise ValueError(f"row width {W} < 0")
        if dev == "cpu":
            return bitpack.compact_bubbles(bw, bv, tail, bits, W)
        lib, fn = _build.load("stages", "mhc_compact_bubbles",
                              _BUBBLES_ARGTYPES)
        R, rounds = bw.shape
        out = torch.empty((R, W), dtype=torch.int32, device=bw.device)
        if R * W == 0:
            return out
        rc = fn(bw.data_ptr(), bv.data_ptr(), tail.data_ptr(), bits.data_ptr(),
                R, rounds, W, out.data_ptr(), _build.stream_ptr(bw.device))
        _build.launched(lib, rc, "compact_bubbles")
        return out


def bubbles_to_payload(bw: torch.Tensor, bv: torch.Tensor,
                       tail: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The same bubble stream, each unit's valid slots counting bits >> 5
    (K6's), straight to the dense word-aligned payload: unit r's
    ceil(bits[r] / 32) words at the exclusive sum of those counts over
    the units before, computed on the device (no host sync). Returns an
    (R * (rounds + 1),) int32 buffer, a bound on the total: the caller
    keeps the first total words once the bits reach the host. The plain
    version zeroes the words past the total; the kernel leaves them
    unwritten. CPU tensors take the plain version; CUDA tensors launch
    K15 (a one-block scan of the word offsets, then the compaction)."""
    with span("mhc.launch.bubbles_to_payload"):
        dev = _check_bubbles(bw, bv, tail, bits)
        if dev == "cpu":
            return bitpack.bubbles_to_payload(bw, bv, tail, bits)
        lib, fn = _build.load("stages", "mhc_bubbles_to_payload",
                              _PAYLOAD_ARGTYPES)
        R, rounds = bw.shape
        out = torch.empty((R * (rounds + 1),), dtype=torch.int32,
                          device=bw.device)
        if R == 0:
            return out
        offs = torch.empty((R + 1,), dtype=torch.int64, device=bw.device)
        rc = fn(bw.data_ptr(), bv.data_ptr(), tail.data_ptr(), bits.data_ptr(),
                R, rounds, offs.data_ptr(), out.data_ptr(),
                _build.stream_ptr(bw.device))
        _build.launched(lib, rc, "bubbles_to_payload")
        return out
