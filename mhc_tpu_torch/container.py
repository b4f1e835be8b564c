"""MHTC container format — the durable artifact of the codec.

Counterpart of `mhc_tpu/container.py` (host numpy/struct code, the same
bytes): the container is the exchange format between the two packages,
in both directions. The payload is a sequence of independently
decodable, byte-aligned blocks with a per-block bit-length index, so
decode parallelism is a property of the FORMAT, not of the decoder
implementation (spec: docs/FORMAT.md).

Layout (little-endian):
  0   4  magic  b"MHTC"
  4   1  version (1)
  5   1  mode    (0 = order-0 Huffman, 1 = Markov-Huffman)
  6   1  flags   bit0: crc32 trailer present; bit1: sub-stream payload
  7   1  log2(decode_unit) when flags bit1, else 0
  8   8  orig_len  u64
  16  4  block_size u32
  20  4  n_blocks  u32
  --- table section ---
  order-0: 128 bytes, nibble-packed code lengths (sym 2i low nibble)
  markov : 32-byte context-presence bitmap, then 128 bytes of nibble-packed
           lengths per present context, ascending context order
  --- index ---
  legacy payload: n_blocks * u32 bit length of each block's stream
  sub-stream payload: n_units * u16 byte length of each unit's stream,
    where units are decode_unit-sized slices of the input
    (n_units = ceil(orig_len / decode_unit)); each unit is byte-aligned
    and independently decodable (Markov context resets per unit)
  --- payload ---
  concatenated byte-aligned streams (block order == unit order)
  --- trailer ---
  crc32 u32 of the original bytes (if flags bit0)

The sub-stream layout is what makes device decode fast: sequential decode
length drops from block_size to decode_unit symbols while the number of
parallel streams multiplies by block_size/decode_unit.

Code lengths alone reconstruct the exact canonical tables on any host
(canonical.py), so tables cost 4 bits/symbol/context with absent contexts
skipped entirely.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

MAGIC = b"MHTC"
VERSION = 1
MODE_ORDER0 = 0
MODE_MARKOV = 1
FLAG_CRC32 = 1
FLAG_SUBSTREAMS = 2
FLAG_PACKED_INDEX = 4
FLAG_GROUPED_INDEX = 8
FLAG_PACKED_TABLES = 16   # table nibbles entropy-coded (markov only)
FLAG_ENTROPY_INDEX = 32   # unit index entropy-coded
# Raw-literal units (round 5): units whose packed stream would occupy
# at least the unit's own bytes in the container layout are stored as
# LITERALS (the original bytes; bits = n_valid*8). Detection is purely
# length-based: a stored unit length equal to the layout size of the
# unit's original bytes means literal — unambiguous because the writer
# forces the substitution at >=, so every non-literal stream is
# strictly shorter. Recovers the Huffman expansion on incompressible
# units (~0.004-0.75 % of their size; far more under a mismatched
# order-0 table) and lets decoders skip entropy decode for them.
FLAG_RAW_UNITS = 128

# Unit streams stored at 4-byte-aligned payload offsets and the index
# stores u32-word counts instead of byte counts. Costs ~2 padding bytes
# per ~3 KB unit stream (~0.06%) and makes payload compaction/expansion
# on the device a pure word gather — no per-byte shifts.
# Markov-only: order-0's size margin vs the oracle on 1 MB text is
# ~40 bytes — aligning its streams would tip it over BASELINE's
# "size <= ref".
FLAG_ALIGNED_PAYLOAD = 64


def aligned_payload(mode: int) -> bool:
    """Whether the writer uses the aligned payload layout for a mode."""
    return mode == MODE_MARKOV


def stream_byte_lens(bit_lengths: np.ndarray, mode: int) -> np.ndarray:
    """Payload bytes each unit stream occupies (layout-aware)."""
    bits = np.asarray(bit_lengths, np.int64)
    if aligned_payload(mode):
        return ((bits + 31) // 32) * 4
    return (bits + 7) // 8

INDEX_GROUP = 512  # units per index group (each group: own base + nbits)


# ---------------------------------------------------------------------------
# tiny order-0 canonical entropy codec for metadata sections. The table
# nibbles and index residual bytes are low-entropy (2.5-7 bits/symbol);
# coding them with their own canonical Huffman code (lengths-only header)
# recovers ~25-40 KB per 100 MB container — the margin that keeps the
# block-parallel format under the reference oracle's size. Decode is
# native (utils/native.py mhc_entropy_decode) with a python fallback.
# ---------------------------------------------------------------------------

def entropy_encode(symbols: np.ndarray, alphabet: int):
    """symbols (n,) uint8 < alphabet -> (lengths uint8[alphabet], coded
    bytes). Canonical order-0 Huffman, MSB-first, max code length 15."""
    from .ops.canonical import canonical_codes_host
    from .utils import native
    syms = np.asarray(symbols, np.uint8)
    counts = np.bincount(syms, minlength=alphabet).astype(np.int64)
    full = np.zeros(256, np.int64)
    full[:alphabet] = counts
    lengths = native.code_lengths(
        full[None, :].astype(np.int32), 15)[0]
    t = canonical_codes_host(lengths.astype(np.int64))
    codes = t["codes"].astype(np.int64)
    lens = lengths.astype(np.int64)
    sl = lens[syms]
    sc = codes[syms]
    if syms.size == 0:
        return lengths[:alphabet].astype(np.uint8), b""
    offs = np.cumsum(sl) - sl
    total_bits = int(offs[-1] + sl[-1])
    W = (total_bits + 31) // 32 + 1
    words = np.zeros(W, np.int64)
    w0 = offs >> 5
    s = offs & 31
    left = 32 - s - sl
    part0 = np.where(left >= 0, sc << np.maximum(left, 0),
                     sc >> np.maximum(-left, 0))
    part1 = np.where(left < 0, sc << (32 + np.minimum(left, 0)), 0)
    np.add.at(words, w0, part0 & 0xFFFFFFFF)
    np.add.at(words, w0 + 1, part1 & 0xFFFFFFFF)
    raw = (words & 0xFFFFFFFF).astype(">u4").tobytes()
    return lengths[:alphabet].astype(np.uint8), raw[: (total_bits + 7) // 8]


def entropy_decode(coded: bytes, lengths: np.ndarray, n_out: int):
    from .utils import native
    return native.entropy_decode(coded, lengths, n_out)

_HEADER = struct.Struct("<4sBBBBQII")


@dataclass
class ContainerMeta:
    mode: int
    orig_len: int
    block_size: int
    n_blocks: int
    flags: int
    decode_unit: int | None   # set when FLAG_SUBSTREAMS
    lengths: np.ndarray       # (256,) order-0 or (256, 256) markov, uint8
    bit_lengths: np.ndarray   # legacy: (n_blocks,) bit lengths, int64
    byte_lengths: np.ndarray  # substream: (n_units,) byte lengths, int64
    index_bytes: int          # serialized index size
    payload_off: int
    crc32: int | None


def pack_nibbles(lengths: np.ndarray) -> bytes:
    """(..., 256) uint8 lengths in 0..15 -> (..., 128) bytes."""
    a = np.asarray(lengths, dtype=np.uint8)
    assert a.shape[-1] % 2 == 0
    lo = a[..., 0::2]
    hi = a[..., 1::2]
    return ((hi << 4) | lo).tobytes()


def unpack_nibbles(raw: bytes, shape) -> np.ndarray:
    b = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty(b.size * 2, dtype=np.uint8)
    out[0::2] = b & 0x0F
    out[1::2] = b >> 4
    return out.reshape(shape)


def serialize_tables(mode: int, lengths: np.ndarray) -> bytes:
    if mode == MODE_ORDER0:
        return pack_nibbles(lengths.reshape(256))
    present = (lengths.reshape(256, 256) > 0).any(axis=1)
    bitmap = np.packbits(present, bitorder="little").tobytes()  # 32 bytes
    rows = pack_nibbles(lengths.reshape(256, 256)[present])
    return bitmap + rows


def serialize_tables_packed(lengths: np.ndarray) -> bytes:
    """Markov tables with the 256*npresent code-length nibbles entropy-
    coded: bitmap(32) + nibble-code lengths (8B, nibble-packed) + coded
    stream. ~2x smaller than raw nibbles on typical corpora."""
    rows = lengths.reshape(256, 256)
    present = (rows > 0).any(axis=1)
    bitmap = np.packbits(present, bitorder="little").tobytes()
    nib = rows[present].reshape(-1)
    code_lens, coded = entropy_encode(nib, 16)
    return bitmap + pack_nibbles(code_lens) + coded


def parse_tables(mode: int, raw: bytes, off: int, packed: bool = False):
    if mode == MODE_ORDER0:
        if len(raw) < off + 128:
            raise ValueError("mhc: truncated container (order-0 table)")
        lengths = unpack_nibbles(raw[off:off + 128], (256,))
        return lengths, off + 128
    if len(raw) < off + 32:
        raise ValueError("mhc: truncated container (context bitmap)")
    bitmap = np.frombuffer(raw[off:off + 32], dtype=np.uint8)
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    off += 32
    npresent = int(present.sum())
    lengths = np.zeros((256, 256), dtype=np.uint8)
    if packed:
        if len(raw) < off + 8:
            raise ValueError("mhc: truncated container (table code lens)")
        code_lens = unpack_nibbles(raw[off:off + 8], (16,))
        off += 8
        # a view: slicing `raw` would copy the whole container
        nib, used = entropy_decode(memoryview(raw)[off:], code_lens,
                                   256 * npresent)
        if np.any(nib >= 16):
            raise ValueError("mhc: corrupt packed table section")
        # the decoder reads zeros past the end: a cut stream must read as
        # truncated, not as lengths (decompress_file reads on for that)
        if len(raw) < off + used:
            raise ValueError("mhc: truncated container (packed tables)")
        off += used
        lengths[present] = nib.reshape(npresent, 256)
        return lengths, off
    if len(raw) < off + 128 * npresent:
        raise ValueError("mhc: truncated container (markov tables)")
    rows = unpack_nibbles(raw[off:off + 128 * npresent], (npresent, 256))
    off += 128 * npresent
    lengths[present] = rows
    return lengths, off


def pack_index_entropy(byte_lens: np.ndarray) -> bytes:
    """Entropy-coded unit index: u16 base + flags byte, then the residual
    low bytes (and high bytes when any residual >= 256) each as an
    entropy-coded stream with a 128 B lengths header."""
    lens = np.asarray(byte_lens, np.int64)
    base = int(lens.min()) if lens.size else 0
    resid = lens - base
    has_hi = int(resid.max()) >= 256 if lens.size else False
    parts = [struct.pack("<HB", base, 1 if has_hi else 0)]
    lo_lens, lo_coded = entropy_encode((resid & 255).astype(np.uint8), 256)
    parts += [pack_nibbles(lo_lens), struct.pack("<I", len(lo_coded)),
              lo_coded]
    if has_hi:
        hi_lens, hi_coded = entropy_encode((resid >> 8).astype(np.uint8),
                                           256)
        parts += [pack_nibbles(hi_lens), struct.pack("<I", len(hi_coded)),
                  hi_coded]
    return b"".join(parts)


def unpack_index_entropy(raw: bytes, off: int, n_units: int):
    if len(raw) < off + 3:
        raise ValueError("mhc: truncated container (entropy index header)")
    base, has_hi = struct.unpack_from("<HB", raw, off)
    off += 3

    def stream(off):
        if len(raw) < off + 132:
            raise ValueError("mhc: truncated container (entropy index)")
        code_lens = unpack_nibbles(raw[off:off + 128], (256,))
        off += 128
        (nb,) = struct.unpack_from("<I", raw, off)
        off += 4
        if len(raw) < off + nb:
            raise ValueError("mhc: truncated container (entropy index)")
        syms, used = entropy_decode(raw[off:off + nb], code_lens, n_units)
        if used > nb:
            raise ValueError("mhc: corrupt entropy index")
        return syms.astype(np.int64), off + nb

    lo, off = stream(off)
    out = base + lo
    if has_hi:
        hi, off = stream(off)
        out = out + (hi << 8)
    return out, off


def pack_index(byte_lens: np.ndarray) -> bytes:
    """Bit-packed unit index: u16 base + u8 nbits + nbits-per-unit
    residuals (LSB-first). Unit stream lengths cluster tightly, so this
    typically costs well under half the flat u16 index."""
    lens = np.asarray(byte_lens, np.int64)
    if lens.size == 0:
        return struct.pack("<HB", 0, 0)
    base = int(lens.min())
    resid = lens - base
    span = int(resid.max())
    nbits = max(span.bit_length(), 0)
    head = struct.pack("<HB", base, nbits)
    if nbits == 0:
        return head
    bits = ((resid[:, None] >> np.arange(nbits)[None, :]) & 1).astype(np.uint8)
    return head + np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def pack_index_grouped(byte_lens: np.ndarray, group: int = INDEX_GROUP) -> bytes:
    """Grouped packed index: per-group u16 base + u8 nbits + byte-aligned
    nbits-per-unit residuals. Unit stream lengths cluster by content
    region (text vs binary vs noise), so per-group parameters beat one
    global (base, nbits) pair on mixed corpora by ~2x."""
    lens = np.asarray(byte_lens, np.int64)
    parts = [struct.pack("<I", group)]
    for g in range(0, lens.size, group):
        gl = lens[g:g + group]
        base = int(gl.min())
        resid = gl - base
        nbits = int(resid.max()).bit_length()
        parts.append(struct.pack("<HB", base, nbits))
        if nbits:
            bits = ((resid[:, None] >> np.arange(nbits)[None, :]) & 1)
            parts.append(np.packbits(bits.reshape(-1).astype(np.uint8),
                                     bitorder="little").tobytes())
    return b"".join(parts)


def unpack_index_grouped(raw: bytes, off: int, n_units: int):
    """Inverse of pack_index_grouped. Returns (byte_lengths int64, off)."""
    if len(raw) < off + 4:
        raise ValueError("mhc: truncated container (grouped index header)")
    (group,) = struct.unpack_from("<I", raw, off)
    off += 4
    if not (0 < group <= 1 << 24):
        raise ValueError("mhc: corrupt grouped index (bad group size)")
    out = np.empty(n_units, np.int64)
    for g in range(0, n_units, group):
        gn = min(group, n_units - g)
        if len(raw) < off + 3:
            raise ValueError("mhc: truncated container (index group)")
        base, nbits = struct.unpack_from("<HB", raw, off)
        off += 3
        if nbits == 0:
            out[g:g + gn] = base
            continue
        nbytes = (gn * nbits + 7) // 8
        if len(raw) < off + nbytes:
            raise ValueError("mhc: truncated container (index group bits)")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8, nbytes, off),
                             bitorder="little")[: gn * nbits]
        out[g:g + gn] = base + (
            bits.reshape(gn, nbits).astype(np.int64)
            << np.arange(nbits)[None, :]).sum(axis=1)
        off += nbytes
    return out, off


def unpack_index(raw: bytes, off: int, n_units: int):
    """Inverse of pack_index. Returns (byte_lengths int64, new offset)."""
    if len(raw) < off + 3:
        raise ValueError("mhc: truncated container (packed index header)")
    base, nbits = struct.unpack_from("<HB", raw, off)
    off += 3
    if nbits == 0:
        return np.full(n_units, base, np.int64), off
    nbytes = (n_units * nbits + 7) // 8
    if len(raw) < off + nbytes:
        raise ValueError("mhc: truncated container (packed index)")
    bits = np.unpackbits(np.frombuffer(raw, np.uint8, nbytes, off),
                         bitorder="little")[: n_units * nbits]
    resid = (bits.reshape(n_units, nbits).astype(np.int64)
             << np.arange(nbits)[None, :]).sum(axis=1)
    return base + resid, off + nbytes


def build_container(mode: int, orig_len: int, block_size: int,
                    lengths: np.ndarray, bit_lengths: np.ndarray,
                    payload, crc: int | None,
                    decode_unit: int | None = None) -> bytes:
    """bit_lengths: per-unit BIT lengths (units are decode_unit slices when
    decode_unit is set, else whole blocks). payload: the byte-aligned unit
    streams, bytes-like, or a list of bytes-like pieces in order (joined
    once, here)."""
    flags = FLAG_CRC32 if crc is not None else 0
    aligned = aligned_payload(mode)
    if decode_unit is not None and decode_unit != block_size:
        # FLAG_RAW_UNITS: the encoders substitute literal streams for
        # incompressible units (engine.compact: K10+K8); readers
        # apply the length-based literal rule only when this bit is set,
        # so pre-round-5 containers keep their original semantics.
        flags |= FLAG_SUBSTREAMS | FLAG_PACKED_INDEX | FLAG_RAW_UNITS
        if aligned:
            flags |= FLAG_ALIGNED_PAYLOAD
        du_log2 = decode_unit.bit_length() - 1
        assert (1 << du_log2) == decode_unit, "decode_unit must be pow2"
        n_blocks = (orig_len + block_size - 1) // block_size
        bits = np.asarray(bit_lengths, np.int64)
        idx_lens = (bits + 31) // 32 if aligned else (bits + 7) // 8
        # the grouped form is self-describing (group size in-stream), so
        # the writer searches several group sizes — unit lengths cluster
        # by content region at region-dependent scales (round 5: the
        # 64-unit order-0 mixed corpus wants small groups)
        variants = [(pack_index(idx_lens), 0),
                    (pack_index_entropy(idx_lens), FLAG_ENTROPY_INDEX)]
        variants += [(pack_index_grouped(idx_lens, group=g),
                      FLAG_GROUPED_INDEX)
                     for g in (32, 64, 128, INDEX_GROUP)]
        index, extra = min(variants, key=lambda v: len(v[0]))
        flags |= extra
    else:
        # legacy whole-block layout keeps exact bit lengths in the index;
        # the payload alignment (if any) is recorded in flag bit 6
        if aligned:
            flags |= FLAG_ALIGNED_PAYLOAD
        du_log2 = 0
        n_blocks = len(bit_lengths)
        index = np.asarray(bit_lengths, dtype="<u4").tobytes()
    tables = serialize_tables(mode, lengths)
    if mode == MODE_MARKOV:
        packed_tables = serialize_tables_packed(lengths)
        if len(packed_tables) < len(tables):
            tables = packed_tables
            flags |= FLAG_PACKED_TABLES
    head = _HEADER.pack(MAGIC, VERSION, mode, flags, du_log2,
                        orig_len, block_size, n_blocks)
    pieces = payload if isinstance(payload, list) else [payload]
    parts = [head, tables, index, *pieces]
    if crc is not None:
        parts.append(struct.pack("<I", crc & 0xFFFFFFFF))
    return b"".join(parts)


def parse_container(blob: bytes, head_only: bool = False,
                    avail: int | None = None) -> ContainerMeta:
    """Parse a container. With head_only=True, `blob` need only cover the
    header + tables + index (the payload may be absent); the returned
    meta has crc32=None but container_size() is exact — this is what lets
    decompress_file stream segment-by-segment without a full-file read.
    `avail` (head_only): the most bytes the container can span, from its
    start (the rest of the file), which bounds the unit count as the
    blob's length does on a full parse."""
    if len(blob) < _HEADER.size:
        raise ValueError("mhc: truncated container (no header)")
    magic, version, mode, flags, du_log2, orig_len, block_size, n_blocks = \
        _HEADER.unpack_from(blob, 0)
    if magic != MAGIC:
        raise ValueError("mhc: bad magic — not an MHTC container")
    if version != VERSION:
        raise ValueError(f"mhc: unsupported container version {version}")
    if mode not in (MODE_ORDER0, MODE_MARKOV):
        raise ValueError(f"mhc: unknown mode {mode}")
    off = _HEADER.size
    lengths, off = parse_tables(mode, blob, off,
                                packed=bool(flags & FLAG_PACKED_TABLES))
    # the lengths size the decode tables of every route, host and device
    from .utils import native
    native.check_code_lengths(lengths)
    idx_start = off
    if flags & FLAG_SUBSTREAMS:
        decode_unit = 1 << du_log2
        n_units = (orig_len + decode_unit - 1) // decode_unit
        # every unit stores a byte at least: an index longer than the
        # rest of the container is not read (nor allocated)
        span = avail if head_only else len(blob)
        if span is not None and n_units > span - off:
            raise ValueError("mhc: truncated container (unit index)")
        bit_lengths = np.zeros((0,), np.int64)
        if flags & FLAG_ENTROPY_INDEX:
            byte_lengths, off = unpack_index_entropy(blob, off, n_units)
        elif flags & FLAG_GROUPED_INDEX:
            byte_lengths, off = unpack_index_grouped(blob, off, n_units)
        elif flags & FLAG_PACKED_INDEX:
            byte_lengths, off = unpack_index(blob, off, n_units)
        else:
            idx_bytes = 2 * n_units
            if len(blob) < off + idx_bytes:
                raise ValueError("mhc: truncated container (unit index)")
            byte_lengths = np.frombuffer(
                blob[off:off + idx_bytes], dtype="<u2").astype(np.int64)
            off += idx_bytes
        if flags & FLAG_ALIGNED_PAYLOAD:
            # index stores u32-word counts; streams sit at aligned
            # offsets, zero-padded — byte_lengths is the aligned length
            byte_lengths = byte_lengths * 4
    else:
        decode_unit = None
        idx_bytes = 4 * n_blocks
        if len(blob) < off + idx_bytes:
            raise ValueError("mhc: truncated container (block index)")
        bit_lengths = np.frombuffer(
            blob[off:off + idx_bytes], dtype="<u4").astype(np.int64)
        if flags & FLAG_ALIGNED_PAYLOAD:
            byte_lengths = ((bit_lengths + 31) // 32) * 4
        else:
            byte_lengths = (bit_lengths + 7) // 8
        off += idx_bytes
    index_bytes = off - idx_start
    # a packed index of wide residuals can read negative
    if byte_lengths.size and int(byte_lengths.min()) < 0:
        raise ValueError("mhc: corrupt container (unit length)")
    payload_len = int(byte_lengths.sum())
    if payload_len < 0:
        raise ValueError("mhc: corrupt container (payload size)")
    crc = None
    tail = off + payload_len
    if not head_only:
        if flags & FLAG_CRC32:
            if len(blob) < tail + 4:
                raise ValueError("mhc: truncated container (crc trailer)")
            crc = struct.unpack_from("<I", blob, tail)[0]
        if len(blob) < tail:
            raise ValueError("mhc: truncated container (payload)")
    return ContainerMeta(mode=mode, orig_len=orig_len, block_size=block_size,
                         n_blocks=n_blocks, flags=flags,
                         decode_unit=decode_unit, lengths=lengths,
                         bit_lengths=bit_lengths, byte_lengths=byte_lengths,
                         index_bytes=index_bytes, payload_off=off, crc32=crc)


def split_payload(blob: bytes, meta: ContainerMeta) -> list[bytes]:
    byte_lens = meta.byte_lengths
    offs = np.concatenate([[0], np.cumsum(byte_lens)]) + meta.payload_off
    return [blob[offs[i]:offs[i + 1]] for i in range(len(byte_lens))]


def payload_to_words(blob: bytes, meta: ContainerMeta, W: int,
                     lo: int = 0, hi: int | None = None) -> np.ndarray:
    """Unit-stream unpacking: payload -> (n_units, W) uint32 (native
    threaded memcpy via utils/native.py, numpy-mask fallback).
    [lo, hi) selects a unit range (chunked decode)."""
    from .utils import native
    byte_lens = meta.byte_lengths[lo:hi]
    n_units = len(byte_lens)
    start = int(meta.byte_lengths[:lo].sum())
    total = int(byte_lens.sum())
    flat = np.frombuffer(
        blob, np.uint8, count=total, offset=meta.payload_off + start)
    buf = native.split_rows(flat, byte_lens, W * 4)
    return buf.view(">u4").astype(np.uint32).reshape(n_units, W)


def container_size(meta: ContainerMeta) -> int:
    """Total byte size of the container a meta was parsed from."""
    size = meta.payload_off + int(meta.byte_lengths.sum())
    if meta.flags & FLAG_CRC32:
        size += 4
    return size


def verify_crc(data: bytes, meta: ContainerMeta) -> None:
    if meta.crc32 is not None and (zlib.crc32(data) & 0xFFFFFFFF) != meta.crc32:
        raise ValueError("mhc: crc32 mismatch — corrupt payload or bad decode")
