"""MHTC container format — the durable artifact of the codec.

Counterpart of `mhc_tpu/container.py` (the same bytes; here the table
section and the unit index are written, and their entropy-coded streams
decoded, by the host library, `utils/native.py`): the container is the
exchange format between the two packages, in both directions. The payload is a sequence of independently
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

from .ops.huffman import MAX_CODE_LEN
from .utils import native

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
# the grouped index is self-describing (group size in-stream), so the
# writer searches several group sizes — unit lengths cluster by content
# region at region-dependent scales (round 5: the 64-unit order-0 mixed
# corpus wants small groups)
INDEX_GROUPS = (32, 64, 128, INDEX_GROUP)

DEFAULT_BLOCK_SIZE = 64 * 1024
# Sequential decode length per stream: 8 KB units keep the 100 MB Markov
# container under the reference oracle's size while giving 8x the
# parallel streams of 64 KB blocks.
DEFAULT_DECODE_UNIT = 8192
DEFAULT_DECODE_UNIT_ORDER0 = 16384


def resolve_decode_unit(block_size: int, decode_unit: int | None,
                        markov: bool = True) -> int:
    """The one parameter check of every writer (`api.compress`, the file
    and hybrid functions, the sharded pipeline, `engine.stage`), run
    before any byte is read or staged; returns the decode unit.
    `block_size` must be an int and a power of two in [1, 2**32): the
    header stores it as a u32. The unit (None: the mode's default) is
    clamped to the block and must be a power of two dividing it; a unit
    of 1 or 2 bytes must be the whole block: the substreams of a block
    may be stored as literal words, which such a unit cannot fill (the
    reference fails there with a TypeError). Anything else raises
    ValueError."""
    if not _is_int(block_size) or not 1 <= block_size < 1 << 32 \
            or block_size & (block_size - 1):
        raise ValueError(f"block_size {block_size!r} must be a power of "
                         "two in [1, 2**32)")
    if decode_unit is not None and not _is_int(decode_unit):
        raise ValueError(f"decode_unit {decode_unit!r} is not an int")
    du = decode_unit or (DEFAULT_DECODE_UNIT if markov
                         else DEFAULT_DECODE_UNIT_ORDER0)
    du = min(du, block_size)
    if du <= 0 or block_size % du != 0 or du & (du - 1):
        raise ValueError(
            f"decode_unit {du} must be a power of two dividing "
            f"block_size {block_size}")
    if du < 4 and du != block_size:
        raise ValueError(
            f"decode_unit {du} under block_size {block_size}: a unit of "
            "fewer than 4 bytes must be the whole block")
    # the u16 unit index requires a worst-case unit stream < 64 KB
    if du != block_size and du * MAX_CODE_LEN // 8 >= (1 << 16):
        raise ValueError(f"decode_unit {du} too large for u16 unit index")
    return int(du)


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def blockify(data, block_size: int):
    """bytes -> ((B, block_size) uint8 zero-padded batch, (B,) int32
    valid counts)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        flat = np.frombuffer(data, dtype=np.uint8)
    else:
        flat = np.asarray(data, dtype=np.uint8).reshape(-1)
    n = flat.size
    if n == 0:
        return np.zeros((0, block_size), np.uint8), np.zeros((0,), np.int32)
    B = (n + block_size - 1) // block_size
    padded = np.zeros(B * block_size, dtype=np.uint8)
    padded[:n] = flat
    n_valid = np.full(B, block_size, dtype=np.int32)
    n_valid[-1] = n - (B - 1) * block_size
    return padded.reshape(B, block_size), n_valid


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


def unpack_nibbles(raw: bytes, shape) -> np.ndarray:
    b = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty(b.size * 2, dtype=np.uint8)
    out[0::2] = b & 0x0F
    out[1::2] = b >> 4
    return out.reshape(shape)


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
        nib, used = native.entropy_decode(memoryview(raw)[off:],
                                          code_lens, 256 * npresent)
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
        syms, used = native.entropy_decode(raw[off:off + nb], code_lens,
                                           n_units)
        if used > nb:
            raise ValueError("mhc: corrupt entropy index")
        return syms.astype(np.int64), off + nb

    lo, off = stream(off)
    out = base + lo
    if has_hi:
        hi, off = stream(off)
        out = out + (hi << 8)
    return out, off


def unpack_index_grouped(raw: bytes, off: int, n_units: int):
    """The grouped index (form 2 + i of `native.write_index`). Returns
    (byte_lengths int64, off)."""
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
    """The flat packed index (form 0 of `native.write_index`). Returns
    (byte_lengths int64, new offset)."""
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


# The table nibbles and index residual bytes are low-entropy (2.5-7
# bits/symbol); coding them with their own canonical order-0 Huffman code
# (lengths-only header) recovers ~25-40 KB per 100 MB container — the
# margin that keeps the block-parallel format under the reference oracle's
# size. The host library writes them (utils/container_writer.cpp, through
# build_container) and decodes them (`native.entropy_decode`).

def _metadata(mode: int, lengths: np.ndarray, idx_lens):
    """(tables, index or None, flags) from the host library, which sizes
    every form and writes only the chosen one: the first shortest index
    and the packed tables where strictly shorter."""
    tables, packed = native.write_tables(mode == MODE_MARKOV, lengths)
    flags = FLAG_PACKED_TABLES if packed else 0
    if idx_lens is None:
        return tables, None, flags
    index, form = native.write_index(idx_lens, INDEX_GROUPS)
    form_flags = (0, FLAG_ENTROPY_INDEX,
                  *(FLAG_GROUPED_INDEX,) * len(INDEX_GROUPS))
    return tables, index, flags | form_flags[form]


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
    idx_lens = None
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
    else:
        # legacy whole-block layout keeps exact bit lengths in the index;
        # the payload alignment (if any) is recorded in flag bit 6
        if aligned:
            flags |= FLAG_ALIGNED_PAYLOAD
        du_log2 = 0
        n_blocks = len(bit_lengths)
    tables, index, extra = _metadata(mode, lengths, idx_lens)
    flags |= extra
    if index is None:
        index = np.asarray(bit_lengths, dtype="<u4").tobytes()
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


def container_size(meta: ContainerMeta) -> int:
    """Total byte size of the container a meta was parsed from."""
    size = meta.payload_off + int(meta.byte_lengths.sum())
    if meta.flags & FLAG_CRC32:
        size += 4
    return size


def verify_crc(data: bytes, meta: ContainerMeta) -> None:
    if meta.crc32 is not None and (zlib.crc32(data) & 0xFFFFFFFF) != meta.crc32:
        raise ValueError("mhc: crc32 mismatch — corrupt payload or bad decode")
