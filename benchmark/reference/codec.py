"""Plain NumPy encoder of the MHTC container, the benchmark's reference.

A frozen, independent copy of the format's writer (docs/FORMAT.md): the
byte histogram (Markov: [prev, cur] with the context reset to 0 at every
decode unit; order-0: one row), length-limited Huffman code lengths
(two-queue merge, ties by weight, then leaf before internal node, then
lower symbol; deflate-style repair to 15 bits), canonical MSB-first
codes, the unit streams (word-aligned for Markov, byte-aligned for
order-0), the literal rule for units whose stream would take at least
their own bytes, and the container's header, tables, index and crc32
trailer, with the metadata sections' own entropy coding.

It imports numpy and the standard library only: nothing of the program
under test, of its JAX reference package, or of JAX. It works across all
units in lockstep, in blocks of units, so 100 MB takes seconds.

`encode(data, mode, block_size, decode_unit, crc)` returns the container
bytes. Its `control` argument breaks one guarantee on purpose, for the
benchmark's control runs (`benchmark/control.py`): "no_crc" writes the
container without its crc32 trailer; "no_literals" codes every unit,
incompressible ones included.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MAX_CODE_LEN = 15
MODE_ORDER0 = 0
MODE_MARKOV = 1
MODES = {"markov": MODE_MARKOV, "order0": MODE_ORDER0,
         "huffman": MODE_ORDER0}
DEFAULT_DECODE_UNIT = {MODE_MARKOV: 8192, MODE_ORDER0: 16384}
CONTROLS = ("no_crc", "no_literals")

FLAG_CRC32 = 1
FLAG_SUBSTREAMS = 2
FLAG_PACKED_INDEX = 4
FLAG_GROUPED_INDEX = 8
FLAG_PACKED_TABLES = 16
FLAG_ENTROPY_INDEX = 32
FLAG_ALIGNED_PAYLOAD = 64
FLAG_RAW_UNITS = 128
INDEX_GROUP = 512
_HEADER = struct.Struct("<4sBBBBQII")
_MAX_TOTAL = 1 << 28
# symbols per block of units in the lockstep encode
_BLOCK_SYMBOLS = 1 << 20


# ---------------------------------------------------------------------------
# code lengths and canonical codes
# ---------------------------------------------------------------------------

def rescale_counts(counts: np.ndarray) -> np.ndarray:
    """(..., 256) counts scaled down by a power of two per row until the
    row's total is under 2**28; a nonzero count stays nonzero."""
    counts = np.asarray(counts, dtype=np.int64)
    total = counts.sum(axis=-1, keepdims=True)
    shift = np.zeros_like(total)
    while np.any(total >> shift >= _MAX_TOTAL):
        shift = np.where(total >> shift >= _MAX_TOTAL, shift + 1, shift)
    scaled = counts >> shift
    return np.where(counts > 0, np.maximum(scaled, 1), 0)


def _row_lengths(counts: list) -> list:
    """Huffman code lengths (unlimited) of one row of 256 rescaled counts,
    as Python ints: symbols sorted by (count, symbol), a two-queue merge
    whose ties take the leaf first."""
    n = len(counts)
    present = [s for s in range(n) if counts[s] > 0]
    m = len(present)
    lengths = [0] * n
    if m == 0:
        return lengths
    if m == 1:
        lengths[present[0]] = 1
        return lengths
    order = sorted(present, key=lambda s: (counts[s], s))
    leaf_w = [counts[s] for s in order]
    int_w = [0] * (m - 1)
    leaf_parent = [0] * m
    int_parent = [0] * (m - 1)
    i = j = 0
    for t in range(m - 1):
        w_sum = 0
        for _ in range(2):
            if i < m and (j >= t or leaf_w[i] <= int_w[j]):
                leaf_parent[i] = t
                w_sum += leaf_w[i]
                i += 1
            else:
                int_parent[j] = t
                w_sum += int_w[j]
                j += 1
        int_w[t] = w_sum
    depth = [0] * (m - 1)
    for t in range(m - 3, -1, -1):
        depth[t] = depth[int_parent[t]] + 1
    for k, s in enumerate(order):
        lengths[s] = depth[leaf_parent[k]] + 1
    return lengths


def _limit_lengths(lengths: list, max_len: int = MAX_CODE_LEN) -> list:
    """Kraft-budget repair: clamp to max_len; while the Kraft sum is over
    budget move one leaf from the deepest level under max_len one level
    down; spend the slack left re-shortening the deepest codes; hand the
    new lengths out in (clamped length, symbol) order."""
    if max(lengths) <= max_len:
        return lengths
    clamped = [min(l, max_len) for l in lengths]
    bl = [0] * (max_len + 1)
    for l in clamped:
        if l:
            bl[l] += 1
    budget = 1 << max_len
    kraft = sum(bl[l] << (max_len - l) for l in range(1, max_len + 1))
    while kraft > budget:
        bits = max(l for l in range(1, max_len) if bl[l] > 0)
        bl[bits] -= 1
        bl[bits + 1] += 1
        kraft -= 1 << (max_len - bits - 1)
    slack = budget - kraft
    for l in range(max_len, 1, -1):
        cost = 1 << (max_len - l)
        k = min(bl[l], slack // cost)
        bl[l] -= k
        bl[l - 1] += k
        slack -= k * cost
    order = sorted((s for s in range(len(lengths)) if lengths[s] > 0),
                   key=lambda s: (clamped[s], s))
    out = [0] * len(lengths)
    new = [l for l in range(max_len + 1) for _ in range(bl[l])]
    for s, l in zip(order, new):
        out[s] = l
    return out


def code_lengths(counts: np.ndarray) -> np.ndarray:
    """(..., 256) counts -> uint8 length-limited code lengths, row by
    row."""
    counts = np.asarray(counts)
    flat = rescale_counts(counts.reshape(-1, counts.shape[-1]))
    rows = [_limit_lengths(_row_lengths(r)) for r in flat.tolist()]
    return np.array(rows, np.uint8).reshape(counts.shape)


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """(..., 256) code lengths -> int64 canonical codes, MSB-first
    (DEFLATE numbering): codes of one length are consecutive in symbol
    order, each length's first code (first[l-1] + count[l-1]) << 1."""
    lens = np.asarray(lengths, np.int64)
    flat = lens.reshape(-1, lens.shape[-1])
    codes = np.zeros_like(flat)
    for r, row in enumerate(flat):
        bl = np.bincount(row, minlength=MAX_CODE_LEN + 1)
        bl[0] = 0
        code, nxt = 0, np.zeros(MAX_CODE_LEN + 1, np.int64)
        for l in range(1, MAX_CODE_LEN + 1):
            code = (code + int(bl[l - 1])) << 1
            nxt[l] = code
        present = np.flatnonzero(row)
        order = present[np.lexsort((present, row[present]))]
        ls = row[order]
        # rank within each length: position minus the length's first
        starts = np.searchsorted(ls, ls, side="left")
        codes[r, order] = nxt[ls] + np.arange(len(order)) - starts
    return codes.reshape(lens.shape)


# ---------------------------------------------------------------------------
# unit streams
# ---------------------------------------------------------------------------

def _symbol_index(flat: np.ndarray, du: int, markov: bool) -> np.ndarray:
    """Each byte's table cell, as a (units, du) array whose last unit is
    zero-padded: prev << 8 | cur (Markov, prev 0 at a unit start) or the
    byte (order-0). `flat` starts at a unit boundary."""
    R = -(-flat.size // du)
    idx = np.zeros(R * du, np.uint16)
    if markov:
        idx[1:flat.size] = flat[:-1]
        idx[::du] = 0
        idx <<= 8
    idx[:flat.size] |= flat
    return idx.reshape(R, du)


def _pack_bits(gbit: np.ndarray, part: np.ndarray,
               n_words: int) -> np.ndarray:
    """Codes at non-decreasing bit positions `gbit` of an MSB-first
    stream, each given left-aligned in 64 bits (`part`, uint64; 0 for a
    symbol that writes nothing) -> (n_words,) uint32 words. A code of at
    most 15 bits shifted right by its position in its first word fits
    that word's 64-bit window; codes never overlap, so the sum of the
    windows of a word is their OR, whose high half is that word's and
    low half the next word's."""
    if gbit.size == 0:
        return np.zeros(n_words, np.uint32)
    w = gbit >> 5
    part = part >> (gbit & 31).astype(np.uint64)
    first = np.flatnonzero(w[1:] != w[:-1])
    first += 1
    first = np.concatenate(([0], first))
    acc = np.add.reduceat(part, first)
    ws = w[first]
    words = np.zeros(n_words + 1, np.uint64)
    words[ws] += acc >> np.uint64(32)
    words[ws + 1] += acc & np.uint64(0xFFFFFFFF)
    return words[:n_words].astype(np.uint32)


def _left_codes(lengths: np.ndarray) -> np.ndarray:
    """Each table cell's canonical code left-aligned in 64 bits (uint64;
    0 for an absent symbol)."""
    lens = lengths.reshape(-1).astype(np.uint64)
    codes = canonical_codes(lengths).reshape(-1).astype(np.uint64)
    return np.where(lens > 0, codes << (np.uint64(64) - lens), 0).astype(
        np.uint64)


def _map(fn, items) -> list:
    """fn over items on a few threads (numpy releases the GIL)."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


def encode_units(data, mode: int, du: int, literals: bool = True):
    """The unit streams of `data` cut into `du`-byte units. Returns
    (code lengths (256, 256) or (256,) uint8, per-unit bit lengths int64
    as the container's index counts them, payload bytes)."""
    flat = np.frombuffer(data, np.uint8) if not isinstance(
        data, np.ndarray) else data.reshape(-1)
    markov = mode == MODE_MARKOV
    aligned = markov
    n = flat.size
    R = -(-n // du)
    per = max(1, _BLOCK_SYMBOLS // du)
    blocks = [(a, min(R, a + per)) for a in range(0, R, per)]
    nv = np.minimum(du, n - np.arange(R, dtype=np.int64) * du)

    def cells(blk):
        a, b = blk
        idx = _symbol_index(flat[a * du: b * du], du, markov)
        counts = np.bincount(idx.reshape(-1)[: int(nv[a:b].sum())],
                             minlength=65536 if markov else 256)
        return idx, counts

    idx_blocks, counts = zip(*_map(cells, blocks))
    counts = np.sum(counts, axis=0)
    lengths = code_lengths(counts.reshape(256, 256) if markov else counts)
    len_tab = lengths.reshape(-1)
    left_tab = _left_codes(lengths)

    def unit_bits(k):
        a, b = blocks[k]
        L = len_tab[idx_blocks[k]]
        L.reshape(-1)[int(nv[a:b].sum()):] = 0
        return L, L.sum(axis=1, dtype=np.int64)

    L_blocks, bits = zip(*_map(unit_bits, range(len(blocks))))
    bits = np.concatenate(bits) if bits else np.zeros(0, np.int64)
    if literals:
        raw = ((bits + 31) // 32 >= (nv + 3) // 4 if aligned
               else (bits + 7) // 8 >= nv)
    else:
        raw = np.zeros(R, bool)
    bit_lens = np.where(raw, nv * 8, bits)
    unit_bytes = ((bit_lens + 31) // 32) * 4 if aligned \
        else (bit_lens + 7) // 8
    unit_off = np.zeros(R + 1, np.int64)
    np.cumsum(unit_bytes, out=unit_off[1:])
    out = np.zeros(int(unit_off[-1]), np.uint8)

    def write(k):
        # the block's streams, written at its units' byte offset
        a, b = blocks[k]
        L = L_blocks[k]
        L[raw[a:b]] = 0
        gbit = np.cumsum(L, axis=1, dtype=np.int64)
        gbit -= L
        gbit += 8 * (unit_off[a:b, None] - unit_off[a])
        part = left_tab[idx_blocks[k]]
        part[L == 0] = 0
        nbytes = int(unit_off[b] - unit_off[a])
        words = _pack_bits(gbit.reshape(-1), part.reshape(-1),
                           nbytes // 4 + 2)
        out[unit_off[a]:unit_off[b]] = np.frombuffer(
            words.astype(">u4").tobytes(), np.uint8)[:nbytes]

    _map(write, range(len(blocks)))
    for u in np.flatnonzero(raw):
        o, s = int(unit_off[u]), u * du
        out[o: o + nv[u]] = flat[s: s + nv[u]]
    return lengths, bit_lens, out


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------

def entropy_encode(symbols: np.ndarray, alphabet: int):
    """(n,) uint8 symbols < alphabet -> (uint8 code lengths of the
    alphabet, coded bytes): canonical order-0 Huffman, MSB-first."""
    syms = np.asarray(symbols, np.uint8)
    full = np.zeros(256, np.int64)
    full[:alphabet] = np.bincount(syms, minlength=alphabet)
    lengths = code_lengths(full)
    if syms.size == 0:
        return lengths[:alphabet], b""
    sl = lengths.astype(np.int64)[syms]
    offs = np.cumsum(sl) - sl
    total_bits = int(offs[-1] + sl[-1])
    words = _pack_bits(offs, _left_codes(lengths)[syms],
                       (total_bits + 31) // 32 + 1)
    raw = words.astype(">u4").tobytes()
    return lengths[:alphabet], raw[: (total_bits + 7) // 8]


def pack_nibbles(lengths: np.ndarray) -> bytes:
    a = np.asarray(lengths, np.uint8)
    return ((a[..., 1::2] << 4) | a[..., 0::2]).astype(np.uint8).tobytes()


def serialize_tables(mode: int, lengths: np.ndarray) -> tuple:
    """(table section, its flag): order-0's 128 bytes of nibbles; Markov's
    context bitmap and its present rows, as nibbles or entropy-coded,
    whichever is shorter."""
    if mode == MODE_ORDER0:
        return pack_nibbles(lengths.reshape(256)), 0
    rows = lengths.reshape(256, 256)
    present = (rows > 0).any(axis=1)
    bitmap = np.packbits(present, bitorder="little").tobytes()
    plain = bitmap + pack_nibbles(rows[present])
    code_lens, coded = entropy_encode(rows[present].reshape(-1), 16)
    packed = bitmap + pack_nibbles(code_lens) + coded
    if len(packed) < len(plain):
        return packed, FLAG_PACKED_TABLES
    return plain, 0


def _index_bits(resid: np.ndarray, nbits: int) -> bytes:
    bits = ((resid[:, None] >> np.arange(nbits)[None, :]) & 1)
    return np.packbits(bits.reshape(-1).astype(np.uint8),
                       bitorder="little").tobytes()


def pack_index(lens: np.ndarray) -> bytes:
    if lens.size == 0:
        return struct.pack("<HB", 0, 0)
    base = int(lens.min())
    nbits = int(lens.max() - base).bit_length()
    head = struct.pack("<HB", base, nbits)
    return head + (_index_bits(lens - base, nbits) if nbits else b"")


def pack_index_entropy(lens: np.ndarray) -> bytes:
    base = int(lens.min()) if lens.size else 0
    resid = lens - base
    has_hi = bool(lens.size) and int(resid.max()) >= 256
    parts = [struct.pack("<HB", base, 1 if has_hi else 0)]
    streams = [resid & 255] + ([resid >> 8] if has_hi else [])
    for s in streams:
        code_lens, coded = entropy_encode(s.astype(np.uint8), 256)
        parts += [pack_nibbles(code_lens), struct.pack("<I", len(coded)),
                  coded]
    return b"".join(parts)


def pack_index_grouped(lens: np.ndarray, group: int) -> bytes:
    parts = [struct.pack("<I", group)]
    for g in range(0, lens.size, group):
        gl = lens[g:g + group]
        base = int(gl.min())
        nbits = int(gl.max() - base).bit_length()
        parts.append(struct.pack("<HB", base, nbits))
        if nbits:
            parts.append(_index_bits(gl - base, nbits))
    return b"".join(parts)


def build_container(mode: int, orig_len: int, block_size: int, du: int,
                    lengths: np.ndarray, bit_lens: np.ndarray,
                    payload, crc: int | None) -> bytes:
    flags = FLAG_CRC32 if crc is not None else 0
    aligned = mode == MODE_MARKOV
    bits = np.asarray(bit_lens, np.int64)
    if du != block_size:
        flags |= FLAG_SUBSTREAMS | FLAG_PACKED_INDEX | FLAG_RAW_UNITS
        if aligned:
            flags |= FLAG_ALIGNED_PAYLOAD
        du_log2 = du.bit_length() - 1
        n_blocks = -(-orig_len // block_size)
        idx_lens = (bits + 31) // 32 if aligned else (bits + 7) // 8
        variants = [(pack_index(idx_lens), 0),
                    (pack_index_entropy(idx_lens), FLAG_ENTROPY_INDEX)]
        variants += [(pack_index_grouped(idx_lens, g), FLAG_GROUPED_INDEX)
                     for g in (32, 64, 128, INDEX_GROUP)]
        index, extra = min(variants, key=lambda v: len(v[0]))
        flags |= extra
    else:
        if aligned:
            flags |= FLAG_ALIGNED_PAYLOAD
        du_log2 = 0
        n_blocks = len(bits)
        index = bits.astype("<u4").tobytes()
    tables, tflag = serialize_tables(mode, lengths)
    flags |= tflag
    head = _HEADER.pack(b"MHTC", 1, mode, flags, du_log2, orig_len,
                        block_size, n_blocks)
    parts = [head, tables, index, bytes(payload)]
    if crc is not None:
        parts.append(struct.pack("<I", crc & 0xFFFFFFFF))
    return b"".join(parts)


def resolve_decode_unit(mode: int, block_size: int,
                        decode_unit: int | None) -> int:
    """The unit the writer uses: the mode's default when None, never
    more than the block."""
    return min(decode_unit or DEFAULT_DECODE_UNIT[mode], block_size)


def encode(data, mode: str, block_size: int, decode_unit: int | None,
           crc: bool = True, control: str | None = None) -> bytes:
    """Container bytes of `data` (bytes or a uint8 array). `control`: None,
    or one of CONTROLS, which breaks one guarantee."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}; one of {CONTROLS}")
    m = MODES[mode]
    du = resolve_decode_unit(m, block_size, decode_unit)
    flat = data if isinstance(data, np.ndarray) else np.frombuffer(
        data, np.uint8)
    checksum = (zlib.crc32(flat) & 0xFFFFFFFF
                if crc and control != "no_crc" else None)
    if flat.size == 0:
        lengths = np.zeros((256, 256) if m == MODE_MARKOV else 256,
                           np.uint8)
        return build_container(m, 0, block_size, du, lengths,
                               np.zeros(0, np.int64), b"", checksum)
    lengths, bit_lens, payload = encode_units(
        flat, m, du, literals=control != "no_literals" and du != block_size)
    return build_container(m, flat.size, block_size, du, lengths, bit_lens,
                           payload, checksum)
