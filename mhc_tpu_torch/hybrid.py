"""Hybrid host/device executor: the unit batch split between the device
and host C++ threads.

Counterpart of `mhc_tpu/hybrid.py`. Every decode-unit stream of a
container is independent, so which side codes a unit is invisible in
the bytes: the native unit codec (native/mhc_codec.cpp) is bit-identical
to the device kernels by construction, and the containers equal
`api.compress`'s at every split. The device takes the unit prefix, the
host threads the tail, and both run at once; the histogram stays global
(device part + host part, summed before the one table build).

host_fraction is the host threads' share of the units: 0.0 is all
device, 1.0 all host. Unlike the reference, a missing native library
raises: the caller asked for host threads.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import api, container, engine
from .config import resolve_device
from .models.entropy import get_model
from .ops import bitpack
from .utils import native


def _device_units(R: int, host_fraction: float) -> int:
    """The device takes units [0, S); the host threads take the rest."""
    if not 0.0 <= host_fraction <= 1.0:
        raise ValueError(f"host_fraction {host_fraction} is not in [0, 1]")
    return R - int(round(R * host_fraction))


def _host_encode(host_bytes: np.ndarray, du: int, lengths: np.ndarray,
                 markov: bool, raw_mode: int):
    return native.encode_units(host_bytes, du,
                               native.build_enc_table(lengths), markov,
                               bitpack.words_for_block(du) * 4,
                               raw_mode=raw_mode)


def compress(data: bytes, mode: str = "markov",
             block_size: int = api.DEFAULT_BLOCK_SIZE,
             decode_unit: int | None = None, crc: bool = True,
             host_fraction: float = 0.5, pack_method: str | None = None,
             device=None) -> bytes:
    """The bytes of api.compress(data, mode, block_size, crc,
    decode_unit): the split is an execution detail."""
    native.require()
    model = get_model(mode)
    pack_method = engine.check_pack_method(pack_method)
    dev = resolve_device(device)
    du = api.resolve_decode_unit(block_size, decode_unit, model.markov)
    n = len(data)
    R = -(-n // du)
    if R == 0:
        return api.compress(data, mode=mode, block_size=block_size,
                            crc=crc, decode_unit=du, device=dev)
    S = _device_units(R, host_fraction)
    split = S * du
    host_bytes = np.frombuffer(data, np.uint8)[split:]

    # pass 1: the global histogram, the device prefix's (queued) while
    # the host threads count the tail, then one table build
    st = (engine.stage(data[:split], mode=mode, block_size=block_size,
                       decode_unit=du, device=dev) if split else None)
    counts_dev = model.histogram(st.units, st.n_valid) if st else None
    counts = (native.hist_markov(host_bytes, du) if model.markov
              else native.hist_order0(host_bytes))
    if counts_dev is not None:
        counts = counts + counts_dev.cpu().numpy().astype(np.int64)
    lengths = np.asarray(model.lengths_from_counts(counts), np.uint8)

    # pass 2: the host threads encode the tail while the device encodes
    # the prefix
    raw_mode = 0 if du == block_size else (
        2 if container.aligned_payload(model.mode) else 1)
    with ThreadPoolExecutor(1) as ex:
        fut = (ex.submit(_host_encode, host_bytes, du, lengths,
                         model.markov, raw_mode)
               if host_bytes.size else None)
        enc = (engine.encode(st, lengths=lengths, pack_method=pack_method)
               if st else None)
        rows, bits_host = (fut.result() if fut else
                           (np.zeros((0, 4), np.uint8),
                            np.zeros((0,), np.int64)))
    payload = ((engine.fetch_payload(enc) if enc else b"")
               + native.join_rows(
                   rows, container.stream_byte_lens(bits_host, model.mode)))
    bit_lens = np.concatenate(
        [enc.bit_lens if enc else np.zeros((0,), np.int64), bits_host])
    checksum = (zlib.crc32(data) & 0xFFFFFFFF) if crc else None
    return container.build_container(
        model.mode, n, block_size, lengths, bit_lens, payload, checksum,
        decode_unit=du)


def _host_decode(blob: bytes, meta, S: int, du: int,
                 starts: np.ndarray) -> bytes:
    byte_lens = meta.byte_lengths[S:].astype(np.int64)
    payload = np.frombuffer(blob, np.uint8, count=int(byte_lens.sum()),
                            offset=meta.payload_off + int(starts[S]))
    out = np.empty(meta.orig_len - S * du, np.uint8)
    raw_mode = 0
    if meta.flags & container.FLAG_RAW_UNITS:
        raw_mode = 2 if meta.flags & container.FLAG_ALIGNED_PAYLOAD else 1
    native.decode_units(payload, starts[S:-1] - starts[S], byte_lens, du,
                        out.size, native.build_dec_lut(meta.lengths),
                        meta.mode == container.MODE_MARKOV, out,
                        raw_mode=raw_mode)
    return out.tobytes()


def _device_decode(blob: bytes, meta, S: int, du: int, starts: np.ndarray,
                   dev: torch.device) -> bytes:
    """The device prefix: its payload staged as an EncodeResult for
    engine.decode."""
    aligned = bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD)
    raw = torch.from_numpy(np.frombuffer(
        blob, np.uint8, count=int(starts[S]),
        offset=meta.payload_off).copy()).to(dev)
    enc = engine.EncodeResult(
        mode=get_model(meta.mode).name, block_size=meta.block_size,
        decode_unit=du, orig_len=min(S * du, meta.orig_len), n_units=S,
        lengths=meta.lengths, byte_lens=meta.byte_lengths[:S], bit_lens=None,
        payload=bitpack.be_bytes_to_words(raw) if aligned else raw,
        raw_units=bool(meta.flags & container.FLAG_RAW_UNITS),
        aligned=aligned)
    return engine.fetch_bytes(enc, engine.decode(enc))


def decompress(blob: bytes, verify: bool = True, host_fraction: float = 0.5,
               device=None) -> bytes:
    """Original bytes of any container, the unit tail decoded by host
    threads while the device decodes the prefix."""
    native.require()
    meta = container.parse_container(blob)
    dev = resolve_device(device)
    if meta.orig_len == 0:
        return b""
    du = meta.decode_unit or meta.block_size
    R = len(meta.byte_lengths)
    if R != -(-meta.orig_len // du):
        raise ValueError("mhc: corrupt container (unit count)")
    # both halves size their rows by the encoder's longest stream
    engine.check_unit_lengths(
        meta.byte_lengths, du,
        bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD), meta.orig_len)
    S = _device_units(R, host_fraction)
    starts = np.zeros(R + 1, np.int64)
    np.cumsum(meta.byte_lengths.astype(np.int64), out=starts[1:])
    with ThreadPoolExecutor(1) as ex:
        fut = (ex.submit(_host_decode, blob, meta, S, du, starts)
               if S < R else None)
        data = (_device_decode(blob, meta, S, du, starts, dev) if S
                else b"") + (fut.result() if fut else b"")
    if verify:
        container.verify_crc(data, meta)
    return data
