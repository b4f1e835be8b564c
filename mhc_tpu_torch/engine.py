"""Device-resident codec engine: encode/decode with buffers on the card.

Counterpart of `mhc_tpu/engine.py`. Input units, the compressed payload
and the decoded output all live in device memory; the only host traffic
is the uint8 code-length header, the per-unit length index and, off a
CUDA card, the counts. The engine launches once over all units it is
given: the
reference's 16 MB chunk loop bounded TPU VMEM and compile size, which a
GPU does not need (the host-bytes API in `api.py` chunks for its copies).

Paths, Markov and order-0 alike:
  encode: histogram (K1 Markov, K2 order-0) -> table build ->
          canonical tables -> lookup+pack -> literal substitution ->
          compaction, where the table build is
            on a CUDA card: K11 on the counts where they lie, none
              fetched; the lengths come back to the host with the bit
              lengths the encode fetches anyway;
            elsewhere: the counts fetched, the native builder
            (`EntropyModel.lengths_for`);
          and lookup+pack is
            pack_method="fused" (default): K3;
            pack_method="dense": K5 (cl plane) then K4 (pack);
            pack_method="pallas": K5 then K6 (bubble stream), compacted
              by `bitpack.compact_bubbles`; for Markov with decode_unit
              == block_size (no literal units) the bubble stream goes
              straight to the payload (`bitpack.bubbles_to_payload`)
  decode: expansion -> decode (K7m Markov, K7o order-0; literal units
          skipped) -> literal overwrite
All three pack methods write the same bytes. The engine payload is
word-aligned in both modes, as in the reference; `fetch_payload` cuts it
to the container's byte-aligned order-0 layout on the host.
`assemble_container()` turns an EncodeResult into the container bytes
that `mhc_tpu.api.compress` writes for the same input.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import api, container
from .config import resolve_device
from .models.entropy import get_model
from .ops import bitpack
from .ops.huffman import MAX_CODE_LEN
from .ops.kernels import decode_cuda, encode_cuda

# the reference's `pack_method` values the port carries
PACK_METHODS = ("fused", "dense", "pallas")
_REJECTED = {
    "merge": "the XLA merge packer, on ROADMAP.md's \"Do not port\" list",
    "scatter": "the XLA scatter packer, on ROADMAP.md's \"Do not port\" "
               "list"}


@dataclass
class Staged:
    """Input unit batch staged on a device."""
    mode: str
    block_size: int
    decode_unit: int
    orig_len: int
    n_units: int
    units: torch.Tensor      # (n_units, decode_unit) uint8, zero-padded
    n_valid: torch.Tensor    # (n_units,) int32


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
          block_size: int = api.DEFAULT_BLOCK_SIZE,
          decode_unit: int | None = None, device=None) -> Staged:
    """Blockify and copy the input to `device`. Not part of codec time."""
    model = get_model(mode)
    dev = resolve_device(device)
    du = api.resolve_decode_unit(block_size, decode_unit, model.markov)
    units, n_valid = api.blockify(data, du)
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


def encode(st: Staged, lengths=None,
           pack_method: str | None = None) -> EncodeResult:
    """Histogram -> table build (`EntropyModel.lengths_for`) ->
    lookup+pack -> literal substitution -> dense word-aligned payload.
    `lengths` (host uint8, or a tensor) overrides the histogram and table
    build; `pack_method` is "fused" (None, K3), "dense" (K5 then K4) or
    "pallas" (K5 then K6)."""
    pack_method = check_pack_method(pack_method)
    model = get_model(st.mode)
    dev = st.units.device
    if lengths is None:
        lengths = model.lengths_for(model.histogram(st.units, st.n_valid))
    tables = model.tables_from_lengths(lengths, dev)
    lengths_host = _start_fetch(lengths)
    tab = (tables["codes"], tables["lengths"])
    aligned = container.aligned_payload(model.mode)
    literals = st.decode_unit != st.block_size   # substream layout
    if pack_method == "pallas" and aligned and not literals:
        # the reference's pack_blocks_to_payload: the bubble stream goes
        # straight to the payload, with no words plane
        bubbles = encode_cuda.bubble_pack(
            encode_cuda.lookup_cl(st.units, st.n_valid, *tab))
        padded = bitpack.bubbles_to_payload(*bubbles)
        bit_lens = bubbles[3].cpu().numpy().astype(np.int64)
        # a copy of the streams, so the result does not hold the padding
        payload = padded[: int(((bit_lens + 31) // 32).sum())].clone()
    else:
        words, bits = _pack(st, tab, pack_method)
        if literals:
            words, bits = bitpack.substitute_raw_units(
                words, bits, st.units, st.n_valid, aligned)
        bit_lens = bits.cpu().numpy().astype(np.int64)
        word_lens = torch.from_numpy((bit_lens + 31) // 32).to(dev)
        payload = bitpack.device_compact_words(words, word_lens)
    return EncodeResult(
        mode=st.mode, block_size=st.block_size, decode_unit=st.decode_unit,
        orig_len=st.orig_len, n_units=st.n_units,
        # the bits fetch above synchronised the stream, copy included
        lengths=lengths_host.numpy(),
        byte_lens=container.stream_byte_lens(bit_lens, model.mode),
        bit_lens=bit_lens, payload=payload, aligned=aligned)


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
    return (bitpack.compact_bubbles(
        *bubbles, bitpack.words_for_block(st.decode_unit)), bubbles[3])


def _offsets(lens: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=out[1:])
    return out


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
    worst = (bitpack.words_for_block(du) * 4 if aligned
             else -(-du * MAX_CODE_LEN // 8))
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
    model = get_model(enc.mode)
    dev = enc.payload.device
    du = enc.decode_unit
    R = enc.n_units
    byte_lens = np.asarray(enc.byte_lens, np.int64)
    check_unit_lengths(byte_lens, du, enc.aligned, enc.orig_len)
    tables = model.tables_from_lengths(enc.lengths, dev)
    if enc.bit_lens is None and not enc.aligned:
        # parsed unaligned container: byte-granular expansion (K12)
        W = int(-(-byte_lens.max() // 4)) + 1 if R else 1
        words = bitpack.device_expand_words(
            enc.payload, torch.from_numpy(_offsets(byte_lens)).to(dev),
            torch.from_numpy(byte_lens).to(dev), W)
    else:
        # word-aligned payload: an engine result knows each unit's words
        # from its bits; a parsed aligned container stores words * 4
        word_lens = ((enc.bit_lens + 31) // 32 if enc.bit_lens is not None
                     else byte_lens // 4).astype(np.int64)
        W = int(word_lens.max()) + 1 if R else 1
        words = bitpack.device_expand_words_u32(
            enc.payload, torch.from_numpy(_offsets(word_lens)).to(dev),
            torch.from_numpy(word_lens).to(dev), W)
    nv = np.full(R, du, np.int64)
    if R:
        nv[-1] = enc.orig_len - (R - 1) * du
    raw = np.zeros(R, bool)
    if enc.raw_units and du != enc.block_size:
        # literal detection follows the CONTAINER layout (the rule the
        # encoder's substitution applies), never the engine's word counts:
        # an order-0 unit whose coded bytes fall short of its length can
        # still round up to the literal's word count
        raw = bitpack.raw_unit_mask(byte_lens, nv, enc.aligned)
    n_dec = torch.from_numpy(np.where(raw, 0, nv).astype(np.int32)).to(dev)
    return words, n_dec, raw, tables


def decode(enc: EncodeResult) -> torch.Tensor:
    """Expansion -> decode (K7m or K7o, literal units skipped) -> literal
    overwrite. Returns the
    (n_units, decode_unit) uint8 rows on the payload's device, zero past
    each unit's length (fetch_bytes trims)."""
    du = enc.decode_unit
    words, n_dec, raw, tables = decode_inputs(enc)
    out = decode_cuda.decode_units(
        words, n_dec, tables["lim"], tables["base"], tables["first_code"],
        tables["sorted_syms"], n_out=du, markov=get_model(enc.mode).markov)
    if raw.any():
        raw_d = torch.from_numpy(raw).to(words.device)
        out = torch.where(raw_d[:, None],
                          bitpack.words_to_unit_bytes(words, du), out)
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
    starts = 4 * _offsets((enc.bit_lens + 31) // 32)
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
