"""Device-resident codec engine: encode/decode with buffers on the card.

Counterpart of `mhc_tpu/engine.py`. Input units, the compressed payload
and the decoded output all live in device memory; the only host traffic
is the uint8 code-length header, the per-unit length index and, off a
CUDA card, the counts. The engine launches once over all units it is
given: the
reference's 16 MB chunk loop bounded TPU VMEM and compile size, which a
GPU does not need (the host-bytes API in `api.py` chunks for its copies).

Paths, Markov and order-0 alike:
  encode: histogram (K1 Markov, K2 order-0) -> table build (lengths and
          canonical tables) -> lookup+pack -> the bits fetched (the
          encode's one sync) and the literal rule applied on the host ->
          literal substitution and compaction (K10+K8), where the table
          build (`EntropyModel.tables_for`) is
            on a CUDA card: one launch of the fused build (K11's lengths
              and K13's tables) on the counts where they lie, none
              fetched; the lengths come back to the host with the bit
              lengths the encode fetches anyway;
            elsewhere: the counts fetched, the native builder, the plain
              tables;
          (given lengths: K13 alone, `EntropyModel.tables_from_lengths`)
          and lookup+pack is
            pack_method="fused" (default): K3;
            pack_method="dense": K5 (cl plane) then K4 (pack);
            pack_method="pallas": K5 then K6 (bubble stream), compacted
              into rows by K15 (`stages_cuda.compact_bubbles`); for
              Markov with decode_unit == block_size (no literal units)
              the bubble stream goes straight to the payload (K15,
              `stages_cuda.bubbles_to_payload`)
  decode: canonical tables (K13) -> expansion (K9 words, K12 the bytes of
          an unaligned container) -> decode (K7m Markov, K7o order-0;
          literal units skipped) -> literal rows (K14)
All three pack methods write the same bytes. The engine payload is
word-aligned in both modes, as in the reference; `fetch_payload` cuts it
to the container's byte-aligned order-0 layout on the host.
`assemble_container()` turns an EncodeResult into the container bytes
that `mhc_tpu.api.compress` writes for the same input.

The host plans the units once each way, in one pass of the host library
(`utils/unit_plan.cpp`) that writes the plan into the staging buffer of
its one upload.

Each host step is a span (`utils.metrics.span`; no span synchronises):
`mhc.engine.encode` around the encode, and inside it `tables` (the
table build, the lengths' fetch started), `pack`, `mhc.wait.bits` (the
bits fetch), `plan` (the literal rule and bounds; the result's lengths),
`upload` and `compact`; `mhc.engine.decode` around the decode, and
inside it `decode_plan` (the units' checks, lengths and literal mask),
`upload`, `tables`, `expand` and `rows` (K7 and the literal rows), each
`mhc.engine.<step>`, the wrappers' launches `mhc.launch.<kernel>`.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import container
from .config import resolve_device
from .models.entropy import get_model
from .ops import bitpack
from .ops.huffman import MAX_CODE_LEN
from .ops.kernels import decode_cuda, encode_cuda, stages_cuda
from .utils import native
from .utils.metrics import span

# the reference's `pack_method` values the port carries
PACK_METHODS = ("fused", "dense", "pallas")
_REJECTED = {
    "merge": "the XLA merge packer, on ROADMAP.md's \"Do not port\" list",
    "scatter": "the XLA scatter packer, on ROADMAP.md's \"Do not port\" "
               "list"}

# each thread's staging buffer for the plans' one upload (`_staging`)
_host = threading.local()


@dataclass
class Staged:
    """Input unit batch staged on a device."""
    mode: str
    block_size: int
    decode_unit: int
    orig_len: int
    n_units: int
    units: torch.Tensor      # (n_units, decode_unit) uint8, zero-padded
    # (n_units,) int32: host_n_valid(orig_len, decode_unit, n_units)
    n_valid: torch.Tensor


@dataclass
class EncodeResult:
    mode: str
    block_size: int
    decode_unit: int
    orig_len: int
    n_units: int
    lengths: np.ndarray      # host uint8 code-length header
    byte_lens: np.ndarray    # host (n_units,) int64 container-layout bytes
    bit_lens: np.ndarray | None   # host (n_units,) int64 (None when parsed)
    # int32 words, the unit streams word-aligned back to back — except for
    # a parsed unaligned container (bit_lens None, aligned False), whose
    # payload is its bytes as uint8, as parsed
    payload: torch.Tensor
    # literal units may be present (the container's FLAG_RAW_UNITS)
    raw_units: bool = True
    # the container layout is word-aligned (FLAG_ALIGNED_PAYLOAD)
    aligned: bool = True


def stage(data: bytes, mode: str = "markov",
          block_size: int = container.DEFAULT_BLOCK_SIZE,
          decode_unit: int | None = None, device=None) -> Staged:
    """Blockify and copy the input to `device`. Not part of codec time."""
    model = get_model(mode)
    dev = resolve_device(device)
    du = container.resolve_decode_unit(block_size, decode_unit,
                                       model.markov)
    units, n_valid = container.blockify(data, du)
    return Staged(mode=model.name, block_size=block_size, decode_unit=du,
                  orig_len=len(data), n_units=units.shape[0],
                  units=torch.from_numpy(units).to(dev),
                  n_valid=torch.from_numpy(n_valid).to(dev))


def histogram(st: Staged) -> np.ndarray:
    """Device histogram over the staged units, fetched to host (int64):
    (256, 256) for Markov, (256,) for order-0."""
    counts = get_model(st.mode).histogram(st.units, st.n_valid)
    return counts.cpu().numpy().astype(np.int64)


def check_pack_method(pack_method: str | None) -> str:
    """None -> "fused"; raises ValueError for anything but PACK_METHODS."""
    pack_method = pack_method or "fused"
    if pack_method in PACK_METHODS:
        return pack_method
    if pack_method in _REJECTED:
        raise ValueError(
            f"pack_method {pack_method!r} is {_REJECTED[pack_method]}; "
            f"the port has {PACK_METHODS}")
    raise ValueError(f"unknown pack_method {pack_method!r}; expected one "
                     f"of {PACK_METHODS}")


def encode(st: Staged, lengths=None, pack_method: str | None = None,
           tables: dict | None = None) -> EncodeResult:
    """Histogram -> table build (`EntropyModel.tables_for`) ->
    lookup+pack -> literal substitution and compaction (`compact`) ->
    dense word-aligned payload. `lengths` (host uint8, or a tensor)
    overrides the histogram and table build, its tables built from it
    (`tables_from_lengths`) unless `tables`, that set already built on
    the units' device, is given with it; `pack_method` is "fused" (None,
    K3), "dense" (K5 then K4) or "pallas" (K5 then K6)."""
    with span("mhc.engine.encode", st.orig_len):
        pack_method = check_pack_method(pack_method)
        model = get_model(st.mode)
        dev = st.units.device
        with span("mhc.engine.tables"):
            if lengths is None:
                if tables is not None:
                    raise ValueError("tables given without their lengths")
                lengths, tables = model.tables_for(
                    model.histogram(st.units, st.n_valid), dev)
            elif tables is None:
                tables = model.tables_from_lengths(lengths, dev)
            elif tables["codes"].device != dev or (
                    torch.is_tensor(lengths) and lengths.device != dev):
                raise ValueError(f"tables on {tables['codes'].device} for "
                                 f"units on {dev}")
            lengths_host = _start_fetch(lengths)
        tab = (tables["codes"], tables["lengths"])
        aligned = container.aligned_payload(model.mode)
        if (pack_method == "pallas" and aligned
                and st.decode_unit == st.block_size):
            # the reference's pack_blocks_to_payload: the bubble stream
            # goes straight to the payload, with no words plane
            with span("mhc.engine.pack"):
                bubbles = encode_cuda.bubble_pack(
                    encode_cuda.lookup_cl(st.units, st.n_valid, *tab))
                padded = stages_cuda.bubbles_to_payload(*bubbles)
            with span("mhc.wait.bits"):
                bits_host = bubbles[3].cpu().numpy()
            # a copy of the streams, so the result does not hold the
            # padding
            with span("mhc.engine.plan"):
                bit_lens, byte_lens, total, _ = _encode_plan(
                    bits_host, st, aligned)
                payload = padded[:total].clone()
        else:
            with span("mhc.engine.pack"):
                packed = _pack(st, tab, pack_method)
            payload, bit_lens, byte_lens = compact(st, *packed, aligned)
        with span("mhc.engine.plan"):
            return EncodeResult(
                mode=st.mode, block_size=st.block_size,
                decode_unit=st.decode_unit, orig_len=st.orig_len,
                n_units=st.n_units,
                # the bits fetch above synchronised the stream, copy
                # included
                lengths=lengths_host.numpy(), byte_lens=byte_lens,
                bit_lens=bit_lens, payload=payload, aligned=aligned)


def compact(st: Staged, words: torch.Tensor, bits: torch.Tensor,
            aligned: bool):
    """The packed rows of `st` -> (dense word-aligned payload, host int64
    bit lengths, host int64 container-layout bytes): the bits fetched
    (the encode's one sync), the unit plan made from them on the host
    (`_encode_plan`: the literal rule where the units are substreams of
    a block, a literal's bits n_valid * 8), its word offsets and literal
    flags uploaded in one copy, then one launch of K10+K8
    (`stages_cuda.compact_units`)."""
    with span("mhc.wait.bits"):
        bits_host = bits.cpu().numpy()
    with span("mhc.engine.plan"):
        bit_lens, byte_lens, total, staged = _encode_plan(bits_host, st,
                                                          aligned)
    offsets, literal = upload_staged(words.device, *staged)
    with span("mhc.engine.compact"):
        payload = stages_cuda.compact_units(
            words, st.units, st.n_valid, offsets, literal, total)
    return payload, bit_lens, byte_lens


def _encode_plan(bits: np.ndarray, st: Staged, aligned: bool):
    """The encode's unit plan from the (R,) int32 coded bit counts of
    `st`'s units: (bit lengths, container-layout bytes, total words,
    staged upload), the two length arrays fresh (R,) int64 and the upload
    the (R + 1,) int64 word offsets with the total last and the (R,)
    uint8 literal flags, in this thread's staging buffer: one native pass
    (`native.plan_encode`)."""
    R = len(bits)
    literal = st.decode_unit != st.block_size
    staged = _staging((np.int64, (R + 1,)), (np.uint8, (R,)))
    bounds, flags = (v for _, v in staged[1])
    bit_lens, byte_lens = np.empty(R, np.int64), np.empty(R, np.int64)
    total = native.plan_encode(bits, st.orig_len, st.decode_unit, literal,
                               aligned, bit_lens, byte_lens, bounds, flags)
    return bit_lens, byte_lens, total, staged


def _start_fetch(lengths) -> torch.Tensor:
    """Host uint8 lengths: numpy as given, a CPU tensor as it is, a CUDA
    tensor copied into pinned memory on the current stream, to be read
    once a later fetch on that stream has synchronised it."""
    if not torch.is_tensor(lengths):
        return torch.from_numpy(np.asarray(lengths, dtype=np.uint8))
    if lengths.device.type != "cuda":
        return lengths.to(torch.uint8)
    host = torch.empty(lengths.shape, dtype=torch.uint8, pin_memory=True)
    return host.copy_(lengths, non_blocking=True)


def _pack(st: Staged, tab, pack_method: str):
    """(words (R, W) int32, bits (R,) int32) of the staged units; the
    three pack methods give the same."""
    if pack_method == "fused":
        return encode_cuda.pack_units(st.units, st.n_valid, *tab)
    cl = encode_cuda.lookup_cl(st.units, st.n_valid, *tab)
    if pack_method == "dense":
        return encode_cuda.pack_cl(cl)
    bubbles = encode_cuda.bubble_pack(cl)
    return (stages_cuda.compact_bubbles(
        *bubbles, bitpack.words_for_block(st.decode_unit)), bubbles[3])


def host_n_valid(orig_len: int, du: int, n_units: int) -> np.ndarray:
    """(n_units,) int64 valid bytes of each unit of `orig_len` bytes cut
    into `du`-byte units: du, the rest in the last, 0 in units past the
    end (a sharded rank's share of the rows)."""
    return np.clip(orig_len - np.arange(n_units, dtype=np.int64) * du, 0,
                   du)


def _bounds(lens: np.ndarray) -> np.ndarray:
    """(R + 1,) int64 offsets of R lengths laid back to back, the total
    last."""
    out = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=out[1:])
    return out


def _staging(*specs) -> tuple:
    """(buffer, [(offset, view)]): one view of each (dtype, shape) spec
    at 8-byte aligned offsets of this thread's staging buffer, the bytes
    between them zeroed; the buffer cut to the last view's end. The
    buffer is reused by the thread's next plan: `upload_staged`'s
    pageable copy has read it when it returns."""
    sizes = [math.prod(shape) * np.dtype(dtype).itemsize
             for dtype, shape in specs]
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // 8) * 8)
    buf = getattr(_host, "buf", None)
    if buf is None or buf.size < starts[-1]:
        buf = _host.buf = np.empty(starts[-1], np.uint8)
    buf = buf[: starts[-1]]
    parts = []
    for (dtype, shape), n, s, e in zip(specs, sizes, starts, starts[1:]):
        if s + n < e:
            buf[s + n: e] = 0
        parts.append((s, buf[s: s + n].view(dtype).reshape(shape)))
    return buf, parts


def upload_staged(dev, buf: np.ndarray, parts: list) -> list:
    """A staged buffer (`_staging`) -> a tensor on `dev` of each view's
    dtype (bool as uint8) and shape, through one copy: each tensor a view
    of the buffer's copy on `dev`."""
    with span("mhc.engine.upload"):
        dev_buf = torch.from_numpy(buf).to(dev, copy=True)
        return [dev_buf[s: s + v.nbytes]
                .view(torch.from_numpy(v[:0]).dtype).reshape(v.shape)
                for s, v in parts]


def upload(dev, *arrays: np.ndarray) -> list:
    """Host numpy arrays -> tensors of their dtypes on `dev` (bool as
    uint8), through one copy: the arrays' bytes at 8-byte aligned
    offsets of one buffer, each tensor a view of it."""
    arrays = [np.ascontiguousarray(a.view(np.uint8) if a.dtype == bool
                                   else a) for a in arrays]
    buf, parts = _staging(*((a.dtype, a.shape) for a in arrays))
    for a, (_, v) in zip(arrays, parts):
        v[...] = a
    return upload_staged(dev, buf, parts)


def _longest_unit(du: int, aligned: bool) -> int:
    """The most container-layout bytes the encoder writes for a unit of
    `du` bytes: its stream row's words_for_block(du) words (aligned), or
    ceil(du * 15 / 8) bytes."""
    return (bitpack.words_for_block(du) * 4 if aligned
            else -(-du * MAX_CODE_LEN // 8))


def check_unit_lengths(byte_lens: np.ndarray, du: int, aligned: bool,
                       orig_len: int) -> None:
    """Raises ValueError when a unit's container-layout length lies
    outside what the encoder can write for its m symbols (`du`, fewer in
    the last unit of `orig_len` bytes). Above: the stream row's
    words_for_block(du) words (aligned layout) or ceil(du * 15 / 8) bytes
    (unaligned); a literal unit, du bytes, is shorter than both. A length
    index rewritten to claim more must not size the expansion buffer.
    Below: every code is a bit at least, so 4 * ceil(m / 32) bytes
    (aligned) or ceil(m / 8); a shorter, or negative, length cannot hold
    the unit, and an `orig_len` that claims more output than the index
    can hold is refused before the output is sized by it."""
    worst = _longest_unit(du, aligned)
    if not len(byte_lens):
        return
    lens = np.asarray(byte_lens, np.int64)
    if int(lens.max()) > worst:
        raise ValueError("mhc: corrupt container (unit length)")
    m = np.full(len(lens), du, np.int64)
    m[-1] = orig_len - (len(lens) - 1) * du
    least = 4 * -(-m // 32) if aligned else -(-m // 8)
    if (lens < least).any():
        raise ValueError("mhc: corrupt container (unit length)")


def decode_inputs(enc: EncodeResult):
    """What decode hands K7: (words (R, W) int32 zero-padded streams,
    n_dec (R,) int32 symbols to decode — 0 for literal units — host
    literal mask (R,) bool, canonical tables). W is at most
    words_for_block(decode_unit) + 1: a longer unit raises ValueError."""
    words, n_dec, _, tables, rows = _decode_inputs(enc)
    raw = np.zeros(enc.n_units, bool)
    raw[rows.cpu().numpy()] = True
    return words, n_dec, raw, tables


def _decode_inputs(enc: EncodeResult):
    """decode_inputs with the literal count in place of the mask, and the
    (n,) int64 indices of the literal rows on the payload's device (K14's
    rows). The host plans the units (`_decode_plan`) and uploads the code
    lengths and the plan in one copy; K13 and K9 follow."""
    model = get_model(enc.mode)
    dev = enc.payload.device
    with span("mhc.engine.decode_plan"):
        W, n_raw, staged = _decode_plan(enc)
    lengths, offsets, n_dec, rows = upload_staged(dev, *staged)
    # a step span around a single launch still holds the stretch before
    # the launch span's own start, which would fall to the caller's span
    with span("mhc.engine.tables"):
        tables = model.tables_from_lengths(lengths, dev)
    with span("mhc.engine.expand"):
        words = stages_cuda.expand_units(enc.payload, offsets, W)
    return words, n_dec, n_raw, tables, rows


def _decode_plan(enc: EncodeResult):
    """The decode's unit plan: (W, the literal count, staged upload), W
    the expansion's row width in words, the upload the code lengths as
    given (uint8), the (R + 1,) int64 offsets of the unit streams in the
    payload, n_dec (R,) int32 and the (n,) int64 literal rows, in this
    thread's staging buffer: one native pass (`native.plan_decode`).
    Raises ValueError first where a unit's length is corrupt, on
    `check_unit_lengths`'s bounds."""
    du = enc.decode_unit
    R = enc.n_units
    byte_lens = np.asarray(enc.byte_lens, np.int64)
    lengths = np.asarray(enc.lengths, np.uint8)
    # literal detection follows the CONTAINER layout (the rule the
    # encoder's substitution applies), never the engine's word counts:
    # an order-0 unit whose coded bytes fall short of its length can
    # still round up to the literal's word count
    literal = enc.raw_units and du != enc.block_size
    buf, parts = _staging((np.uint8, lengths.shape), (np.int64, (R + 1,)),
                          (np.int32, (R,)), (np.int64, (R,)))
    lens_v, bounds, n_dec, rows = (v for _, v in parts)
    W, n_raw = native.plan_decode(byte_lens, enc.bit_lens, enc.orig_len,
                                  du, enc.aligned, literal,
                                  _longest_unit(du, enc.aligned), bounds,
                                  n_dec, rows)
    lens_v[...] = lengths
    # the rows, last, cut to the literals
    s = parts[-1][0]
    parts[-1] = (s, rows[:n_raw])
    return W, n_raw, (buf[: s + 8 * n_raw], parts)


def row_width(enc: EncodeResult) -> int:
    """The width of the decoded rows: the decode unit, or, where `enc`
    holds fewer bytes than one unit (its one unit is short), those bytes
    rounded up to 16, so that a legacy container's short block is never
    sized by the block size in its header. The rounding keeps K7's
    16-byte stores and K14's whole words: a literal unit's row holds its
    n_valid bytes, so it is never wider than this (units of 1 or 2 bytes
    are whole blocks, with no literals)."""
    return min(enc.decode_unit, -(-enc.orig_len // 16) * 16)


def decode(enc: EncodeResult) -> torch.Tensor:
    """Tables and expansion -> decode (K7m or K7o, literal units
    skipped) -> literal rows (K14). Returns the (n_units, row_width(enc))
    uint8 rows on the payload's device, zero past each unit's length
    (fetch_bytes trims)."""
    with span("mhc.engine.decode", enc.orig_len):
        words, n_dec, n_raw, tables, rows = _decode_inputs(enc)
        with span("mhc.engine.rows"):
            out = decode_cuda.decode_units(
                words, n_dec, tables["lim"], tables["base"],
                tables["first_code"], tables["sorted_syms"],
                n_out=row_width(enc), markov=get_model(enc.mode).markov)
            if n_raw:
                stages_cuda.literal_rows(out, words, rows)
        return out


def fetch_bytes(enc: EncodeResult, out: torch.Tensor) -> bytes:
    """Decoded rows -> original bytes (host). Not codec time."""
    return out.cpu().numpy().reshape(-1).tobytes()[: enc.orig_len]


def be_payload(enc: EncodeResult) -> torch.Tensor:
    """The engine payload's words as big-endian bytes, on its device."""
    return bitpack.words_to_be_bytes(enc.payload)


def payload_bytes(enc: EncodeResult, be: np.ndarray):
    """Container-layout payload, bytes-like, from `be_payload(enc)` on the
    host: `be` itself where the layout is word-aligned, else each unit cut
    to its ceil(bits / 8) bytes (order-0)."""
    if enc.aligned:
        return be
    mv = memoryview(be)
    starts = 4 * _bounds((enc.bit_lens + 31) // 32)[:-1]
    return b"".join(mv[s: s + n] for s, n in
                    zip(starts.tolist(), enc.byte_lens.tolist()))


def fetch_payload(enc: EncodeResult) -> bytes:
    """Dense container-layout payload bytes (host). Not codec time."""
    return bytes(payload_bytes(enc, be_payload(enc).cpu().numpy()))


def assemble_container(enc: EncodeResult, data_crc: int | None) -> bytes:
    """Container bytes from an EncodeResult — the bytes `api.compress`
    writes for the same input and parameters."""
    return container.build_container(
        get_model(enc.mode).mode, enc.orig_len, enc.block_size,
        enc.lengths, enc.bit_lens, fetch_payload(enc), data_crc,
        decode_unit=enc.decode_unit)
