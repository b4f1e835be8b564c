"""Unit-stream layout helpers around the kernels, in plain torch.

Counterpart of the XLA (non-Pallas) parts of `mhc_tpu/ops/bitpack.py`
that the main paths run: the worst-case stream width, literal units, the
dense aligned payload's compaction and expansion, the two compactions of
K6's bubble stream (`compact_bubbles`, `bubbles_to_payload`, from
`mhc_tpu/ops/kernels/encode_pallas.py`), and the byte-granular expansion
of an unaligned container payload. These stages are kernels on a card
(`ops/kernels/stages_cuda.py`, `csrc/stages.cu`), and their plain
versions live here: `compact_units_plain` (K10+K8, literal substitution
and compaction), `expand_units_plain` (K9/K12), `literal_rows_plain`
(K14), `compact_bubbles` and `bubbles_to_payload` (K15). The byte <->
word conversions of the host-bytes API stay plain torch: the reference
does that step on the host (`astype(">u4")`), not on its chip.

Words are kept as torch.int32 bit patterns: torch's uint32 lacks shifts
and many CPU ops. Bit order is MSB-first within each 32-bit word, and
words are big-endian when serialized, so the byte stream equals the
conceptual MSB-first bitstream. Byte <-> big-endian word conversions
below go through a uint8 view and a flip of each 4-byte group, which
relies on a little-endian host and device (x86, ARM and every CUDA card).
"""

from __future__ import annotations

import numpy as np
import torch

from .huffman import MAX_CODE_LEN


def words_for_block(block_size: int, max_len: int = MAX_CODE_LEN) -> int:
    """u32 words that hold a worst-case encoded unit, +1 slack word."""
    return (block_size * max_len + 31) // 32 + 1


def _be_words(units: torch.Tensor) -> torch.Tensor:
    """(R, du) uint8, du a multiple of 4 -> (R, du/4) int32 big-endian
    words."""
    R, du = units.shape
    if du % 4:
        raise ValueError(f"rows of {du} bytes are not whole words")
    return units.reshape(R, du // 4, 4).flip(-1).contiguous().view(
        torch.int32).reshape(R, du // 4)


def words_to_be_bytes(words: torch.Tensor) -> torch.Tensor:
    """(T,) int32 words -> (4T,) uint8, each word big-endian (the
    container's byte order)."""
    return words.view(torch.uint8).reshape(-1, 4).flip(1).reshape(-1)


def be_bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """(4T,) uint8 big-endian words -> (T,) int32."""
    return _be_words(b.reshape(1, -1))[0]


# ---------------------------------------------------------------------------
# Raw-literal units (container FLAG_RAW_UNITS). A unit whose packed stream
# would occupy at least the unit's own bytes in the container layout is
# stored as a LITERAL: the original bytes, big-endian word-packed, with
# bits = n_valid * 8. Detection is length-based and unambiguous: stored
# lengths reach the layout size of the unit's bytes iff it is a literal.
# ---------------------------------------------------------------------------

def literal_words(units: torch.Tensor, n_valid: torch.Tensor,
                  W: int) -> torch.Tensor:
    """(R, du) uint8 units, (R,) n_valid -> (R, W) int32: each unit's
    bytes past n_valid zeroed, big-endian word-packed, zero past du / 4
    words."""
    R, du = units.shape
    if W < du // 4:
        raise ValueError(f"stream width {W} cannot hold a {du}-byte "
                         "literal unit")
    pos = torch.arange(du, device=units.device)
    masked = torch.where(pos[None, :] < n_valid.long()[:, None], units,
                         torch.zeros((), dtype=torch.uint8,
                                     device=units.device))
    uw = torch.zeros((R, W), dtype=torch.int32, device=units.device)
    uw[:, : du // 4] = _be_words(masked)
    return uw


def substitute_raw_units(words: torch.Tensor, bits: torch.Tensor,
                         units: torch.Tensor, n_valid: torch.Tensor,
                         aligned: bool):
    """Post-pack literal substitution. words (R, W) int32 packed streams,
    bits (R,) int32, units (R, du) uint8, n_valid (R,) int32. Returns
    (words', bits') with literal units' streams replaced by their
    original bytes and bits' = n_valid * 8."""
    b = bits.long()
    nv = n_valid.long()
    if aligned:
        raw = (b + 31) // 32 >= (nv + 3) // 4
    else:
        raw = (b + 7) // 8 >= nv
    uw = literal_words(units, n_valid, words.shape[1])
    words_out = torch.where(raw[:, None], uw, words)
    bits_out = torch.where(raw, (nv * 8).to(bits.dtype), bits)
    return words_out, bits_out


def literal_unit_mask(bits: np.ndarray, n_valid: np.ndarray,
                      aligned: bool) -> np.ndarray:
    """Encode-side literal rule of `substitute_raw_units` on host numpy
    bit counts: a unit is stored as its bytes when its coded stream
    takes at least as much of the container layout (aligned: words,
    else bytes)."""
    b = np.asarray(bits, np.int64)
    nv = np.asarray(n_valid, np.int64)
    if aligned:
        return (b + 31) // 32 >= (nv + 3) // 4
    return (b + 7) // 8 >= nv


def raw_unit_mask(stored_byte_lens: np.ndarray, n_valid: np.ndarray,
                  aligned: bool) -> np.ndarray:
    """Decode-side literal detection from the container index (host
    numpy). stored_byte_lens are LAYOUT bytes (aligned: word count * 4).
    Rows with n_valid 0 are never literal."""
    sl = np.asarray(stored_byte_lens, np.int64)
    nv = np.asarray(n_valid, np.int64)
    if aligned:
        return (sl == ((nv + 3) // 4) * 4) & (nv > 0)
    return (sl == nv) & (nv > 0)


def words_to_unit_bytes(words: torch.Tensor, du: int) -> torch.Tensor:
    """(R, W) int32 big-endian stream words -> (R, du) uint8 literal
    bytes. W may be narrower than du/4 when only a ragged final unit is
    literal (the stream buffer is sized by the longest stream): the rest
    reads as zeros."""
    R, W = words.shape
    w = torch.zeros((R, du // 4), dtype=torch.int32, device=words.device)
    k = min(W, du // 4)
    w[:, :k] = words[:, :k]
    return w.view(torch.uint8).reshape(R, du // 4, 4).flip(-1).reshape(
        R, du)


def literal_rows_plain(out: torch.Tensor, words: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """K14's plain version: the literal rows `rows` ((n,) int64) of the
    decoded (R, du) uint8 `out` overwritten, in place, with
    `words_to_unit_bytes` of their (R, W) int32 stream words; returns
    `out`."""
    R, du = out.shape
    raw = torch.zeros(R, dtype=torch.bool, device=out.device)
    raw[rows] = True
    out.copy_(torch.where(raw[:, None], words_to_unit_bytes(words, du), out))
    return out


# ---------------------------------------------------------------------------
# Dense aligned payload: unit streams back to back at word granularity.
# ---------------------------------------------------------------------------

def device_compact_words(words: torch.Tensor,
                         word_lens: torch.Tensor) -> torch.Tensor:
    """(R, W) int32 streams + (R,) word counts -> (sum,) int32 dense
    payload, unit after unit (a boolean mask selects row-major)."""
    W = words.shape[1]
    keep = (torch.arange(W, device=words.device)[None, :]
            < word_lens.to(words.device)[:, None])
    return words[keep]


def compact_units_plain(words: torch.Tensor, units: torch.Tensor,
                        n_valid: torch.Tensor, word_offsets: torch.Tensor,
                        literal: torch.Tensor, total: int) -> torch.Tensor:
    """K10+K8's plain version: `substitute_raw_units`' literal rows on
    the host's literal flags, then `device_compact_words` on the host's
    word offsets ((R + 1,) int64, the total last). Returns the (total,)
    int32 dense payload. Literal rows are built for the flagged units
    alone: a unit of 1 or 2 bytes (decode_unit == block_size) is never
    flagged and has no whole word of bytes."""
    rows = words
    lit = literal.bool()
    if lit.any():
        rows = words.clone()
        rows[lit] = literal_words(units[lit], n_valid[lit], words.shape[1])
    out = device_compact_words(rows, word_offsets[1:] - word_offsets[:-1])
    if out.numel() != total:
        raise ValueError(f"word offsets give {out.numel()} words, not "
                         f"{total}")
    return out


# ---------------------------------------------------------------------------
# Bubble streams, K6's output: per unit one (word, valid) slot per round of
# two codes, the pending tail word and the bit count. A unit's k-th valid
# slot is its word k; the tail follows where bits % 32 != 0. Slots that
# are not valid are written to dump positions past the result, one per
# unit, so that no two writes of a valid word meet.
# ---------------------------------------------------------------------------

def compact_bubbles(bw: torch.Tensor, bv: torch.Tensor, tail: torch.Tensor,
                    bits: torch.Tensor, W: int) -> torch.Tensor:
    """K15's plain version (`stages_cuda.compact_bubbles`): (R, rounds)
    bubble words and 0/1 flags, (R,) tail and bits -> (R, W) int32
    streams, zero past each: K4's words for the same cl plane."""
    R = bw.shape[0]
    b = bits.long()
    pos = torch.cumsum(bv, dim=1, dtype=torch.long) - 1
    words = torch.zeros((R, W + 1), dtype=torch.int32, device=bw.device)
    words.scatter_(1, torch.where(bv > 0, pos, W), bw)
    words.scatter_(1, torch.where(b & 31 > 0, b >> 5, W)[:, None],
                   tail[:, None])
    return words[:, :W]


def bubbles_to_payload(bw: torch.Tensor, bv: torch.Tensor,
                       tail: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """K15's plain version (`stages_cuda.bubbles_to_payload`): the
    bubble stream straight to the dense aligned payload, each
    unit's word offset an exclusive cumsum of ceil(bits / 32) on the
    device, so no host sync. The result has R * (rounds + 1) words, a
    bound on the total (a round completes at most one word), zero past
    the streams: the caller cuts it to the total once the bits reach the
    host."""
    R, rounds = bw.shape
    dev = bw.device
    b = bits.long()
    wl = (b + 31) >> 5
    offs = torch.cumsum(wl, 0) - wl
    pad = R * (rounds + 1)
    dump = pad + torch.arange(R, device=dev)
    pos = torch.cumsum(bv, dim=1, dtype=torch.long) - 1
    payload = torch.zeros(pad + R, dtype=torch.int32, device=dev)
    payload[torch.where(bv > 0, offs[:, None] + pos, dump[:, None])] = bw
    payload[torch.where(b & 31 > 0, offs + (b >> 5), dump)] = tail
    return payload[:pad]


def device_expand_words_u32(payload: torch.Tensor,
                            word_offsets: torch.Tensor,
                            word_lens: torch.Tensor, W: int) -> torch.Tensor:
    """Inverse of device_compact_words: (T,) int32 payload + (R,) word
    offsets and lengths -> (R, W) int32 zero-padded streams."""
    R = word_lens.shape[0]
    dev = payload.device
    T = payload.shape[0]
    if T == 0 or R == 0:
        return torch.zeros((R, W), dtype=torch.int32, device=dev)
    iw = torch.arange(W, device=dev)
    idx = word_offsets.to(dev).long()[:, None] + iw[None, :]
    val = payload[idx.clamp(0, T - 1)]
    ok = iw[None, :] < word_lens.to(dev)[:, None]
    return torch.where(ok, val, torch.zeros((), dtype=torch.int32,
                                              device=dev))


def expand_units_plain(payload: torch.Tensor, offsets: torch.Tensor,
                       W: int) -> torch.Tensor:
    """K9/K12's plain version: a (T,) payload and (R + 1,) int64 offsets
    into it (the total last) -> (R, W) int32 zero-padded big-endian
    stream rows. int32 words take `device_expand_words_u32` (the
    word-aligned layout); uint8 bytes take `device_expand_words` (the
    unaligned order-0 container)."""
    lens = offsets[1:] - offsets[:-1]
    if payload.dtype == torch.uint8:
        return device_expand_words(payload, offsets[:-1], lens, W)
    return device_expand_words_u32(payload, offsets[:-1], lens, W)


def device_expand_words(payload: torch.Tensor, byte_offsets: torch.Tensor,
                        byte_lens: torch.Tensor, W: int) -> torch.Tensor:
    """Byte-granular expansion (unaligned container layout): (T,) uint8
    payload + (R,) byte offsets and lengths -> (R, W) int32 zero-padded
    big-endian word streams."""
    R = byte_lens.shape[0]
    dev = payload.device
    T = payload.shape[0]
    if T == 0 or R == 0:
        return torch.zeros((R, W), dtype=torch.int32, device=dev)
    ib = torch.arange(4 * W, device=dev)
    idx = byte_offsets.to(dev).long()[:, None] + ib[None, :]
    ok = ib[None, :] < byte_lens.to(dev)[:, None]
    b = torch.where(ok, payload[idx.clamp(0, T - 1)],
                    torch.zeros((), dtype=torch.uint8, device=dev))
    return _be_words(b)
