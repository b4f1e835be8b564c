"""Device-resident codec engine: encode/decode with buffers on the card.

Counterpart of `mhc_tpu/engine.py`. Input units, the compressed payload
and the decoded output all live in device memory; the only host traffic
is the (256, 256) counts, the uint8 code-length header and the per-unit
length index. The engine launches once over all units: the reference's
16 MB chunk loop bounded TPU VMEM and compile size, which a GPU does not
need.

Main path (Markov):
  encode: histogram (K1) -> host table build -> canonical tables ->
          fused lookup+pack (K3) -> literal substitution -> compaction
  decode: expansion -> decode (K7, literal units skipped) -> literal
          overwrite
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
from .ops.kernels import decode_cuda, encode_cuda


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
    lengths: np.ndarray      # host (256, 256) uint8 code-length header
    byte_lens: np.ndarray    # host (n_units,) int64 container-layout bytes
    bit_lens: np.ndarray | None   # host (n_units,) int64 (None when parsed)
    payload: torch.Tensor    # (total words,) int32 dense aligned payload
    # literal units may be present (the container's FLAG_RAW_UNITS)
    raw_units: bool = True


def stage(data: bytes, mode: str = "markov",
          block_size: int = api.DEFAULT_BLOCK_SIZE,
          decode_unit: int | None = None, device=None) -> Staged:
    """Blockify and copy the input to `device`. Not part of codec time."""
    model = get_model(mode)
    model.require_markov()
    dev = resolve_device(device)
    du = api.resolve_decode_unit(block_size, decode_unit, model.markov)
    units, n_valid = api.blockify(data, du)
    return Staged(mode=model.name, block_size=block_size, decode_unit=du,
                  orig_len=len(data), n_units=units.shape[0],
                  units=torch.from_numpy(units).to(dev),
                  n_valid=torch.from_numpy(n_valid).to(dev))


def histogram(st: Staged) -> np.ndarray:
    """Device histogram over the staged units, fetched to host (int64)."""
    counts = get_model(st.mode).histogram(st.units, st.n_valid)
    return counts.cpu().numpy().astype(np.int64)


def encode(st: Staged, lengths: np.ndarray | None = None) -> EncodeResult:
    """Histogram -> host table build -> fused lookup+pack -> literal
    substitution -> dense payload, all but the table build on the
    device. `lengths` overrides the histogram and table build."""
    model = get_model(st.mode)
    dev = st.units.device
    if lengths is None:
        lengths = model.lengths_from_counts(histogram(st))
    lengths = np.asarray(lengths, dtype=np.uint8)
    tables = model.tables_from_lengths(lengths, dev)
    words, bits = encode_cuda.pack_units(st.units, st.n_valid,
                                         tables["codes"], tables["lengths"])
    if st.decode_unit != st.block_size:          # substream layout
        words, bits = bitpack.substitute_raw_units(
            words, bits, st.units, st.n_valid,
            container.aligned_payload(model.mode))
    bit_lens = bits.cpu().numpy().astype(np.int64)
    word_lens = torch.from_numpy((bit_lens + 31) // 32).to(dev)
    payload = bitpack.device_compact_words(words, word_lens)
    return EncodeResult(
        mode=st.mode, block_size=st.block_size, decode_unit=st.decode_unit,
        orig_len=st.orig_len, n_units=st.n_units, lengths=lengths,
        byte_lens=container.stream_byte_lens(bit_lens, model.mode),
        bit_lens=bit_lens, payload=payload)


def decode_inputs(enc: EncodeResult):
    """What decode hands K7: (words (R, W) int32 zero-padded streams,
    n_dec (R,) int32 symbols to decode — 0 for literal units — host
    literal mask (R,) bool, canonical tables)."""
    model = get_model(enc.mode)
    dev = enc.payload.device
    du = enc.decode_unit
    R = enc.n_units
    tables = model.tables_from_lengths(enc.lengths, dev)
    word_lens = np.asarray(enc.byte_lens, np.int64) // 4
    W = int(word_lens.max()) + 1 if R else 1
    offsets = np.zeros(R, np.int64)
    np.cumsum(word_lens[:-1], out=offsets[1:])
    words = bitpack.device_expand_words_u32(
        enc.payload, torch.from_numpy(offsets).to(dev),
        torch.from_numpy(word_lens).to(dev), W)
    nv = np.full(R, du, np.int64)
    if R:
        nv[-1] = enc.orig_len - (R - 1) * du
    raw = np.zeros(R, bool)
    if enc.raw_units and du != enc.block_size:
        # literal detection follows the CONTAINER layout (the rule the
        # encoder's substitution applies)
        raw = bitpack.raw_unit_mask(enc.byte_lens, nv,
                                    container.aligned_payload(model.mode))
    n_dec = torch.from_numpy(np.where(raw, 0, nv).astype(np.int32)).to(dev)
    return words, n_dec, raw, tables


def decode(enc: EncodeResult) -> torch.Tensor:
    """Expansion -> decode (K7) -> literal overwrite. Returns the
    (n_units, decode_unit) uint8 rows on the payload's device, zero past
    each unit's length (fetch_bytes trims)."""
    du = enc.decode_unit
    words, n_dec, raw, tables = decode_inputs(enc)
    out = decode_cuda.decode_units(
        words, n_dec, tables["lim"], tables["base"], tables["first_code"],
        tables["sorted_syms"], n_out=du)
    if raw.any():
        raw_d = torch.from_numpy(raw).to(words.device)
        out = torch.where(raw_d[:, None],
                          bitpack.words_to_unit_bytes(words, du), out)
    return out


def fetch_bytes(enc: EncodeResult, out: torch.Tensor) -> bytes:
    """Decoded rows -> original bytes (host). Not codec time."""
    return out.cpu().numpy().reshape(-1).tobytes()[: enc.orig_len]


def fetch_payload(enc: EncodeResult) -> bytes:
    """Dense container payload bytes (host): big-endian words. Not codec
    time."""
    return enc.payload.cpu().numpy().view(np.uint32).astype(">u4").tobytes()


def assemble_container(enc: EncodeResult, data_crc: int | None) -> bytes:
    """Container bytes from an EncodeResult — the bytes `api.compress`
    writes for the same input and parameters."""
    return container.build_container(
        get_model(enc.mode).mode, enc.orig_len, enc.block_size,
        enc.lengths, enc.bit_lens, fetch_payload(enc), data_crc,
        decode_unit=enc.decode_unit)
