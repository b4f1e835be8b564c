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
device, 1.0 all host; None (the default, as in the reference) reads
MHC_HOST_FRACTION, else 0.5. Unlike the reference, a share outside
[0, 1] raises ValueError where it clamps, and a missing native library
raises: the caller asked for host threads.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import api, container, engine
from .config import resolve_device
from .models.entropy import get_model
from .ops import bitpack
from .utils import native


def _fraction(host_fraction: float | None) -> float:
    """The host threads' share: `host_fraction`, or (None) the
    MHC_HOST_FRACTION variable, else 0.5. Unlike the reference, which
    clamps, a share outside [0, 1] raises ValueError."""
    name = "host_fraction"
    if host_fraction is None:
        name = "MHC_HOST_FRACTION"
        text = os.environ.get(name, "0.5")
        try:
            host_fraction = float(text)
        except ValueError:
            raise ValueError(f"{name} {text!r} is not a number") from None
    if not 0.0 <= host_fraction <= 1.0:
        raise ValueError(f"{name} {host_fraction} is not in [0, 1]")
    return host_fraction


def _device_units(R: int, host_fraction: float) -> int:
    """The device takes units [0, S); the host threads take the rest."""
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
             host_fraction: float | None = None,
             pack_method: str | None = None, device=None) -> bytes:
    """The bytes of api.compress(data, mode, block_size, crc,
    decode_unit): the split is an execution detail. `host_fraction`
    None reads MHC_HOST_FRACTION, else 0.5 (`_fraction`)."""
    model = get_model(mode)
    du = api.resolve_decode_unit(block_size, decode_unit, model.markov)
    host_fraction = _fraction(host_fraction)
    pack_method = engine.check_pack_method(pack_method)
    native.require()
    dev = resolve_device(device)
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


def _device_decode(blob: bytes, meta, S: int, starts: np.ndarray,
                   dev: torch.device) -> bytes:
    """The device prefix, units [0, S), through engine.decode."""
    raw = torch.from_numpy(np.frombuffer(
        blob, np.uint8, count=int(starts[S]),
        offset=meta.payload_off).copy()).to(dev)
    enc = api.parsed_chunk(meta, 0, S, raw)
    return engine.fetch_bytes(enc, engine.decode(enc))


def decompress(blob: bytes, verify: bool = True,
               host_fraction: float | None = None, device=None) -> bytes:
    """Original bytes of any container, the unit tail decoded by host
    threads while the device decodes the prefix; `host_fraction` as in
    `compress`."""
    host_fraction = _fraction(host_fraction)
    native.require()
    meta = container.parse_container(blob)
    dev = resolve_device(device)
    if meta.orig_len == 0:
        # an orig_len rewritten to 0 still meets the crc of the bytes
        if verify:
            container.verify_crc(b"", meta)
        return b""
    # the checks of every route, before anything is sized by the header;
    # both halves size their rows by the encoder's longest stream
    du, byte_lens, starts = api.check_parsed(meta)
    starts = starts - meta.payload_off
    R = len(byte_lens)
    S = _device_units(R, host_fraction)
    with ThreadPoolExecutor(1) as ex:
        fut = (ex.submit(_host_decode, blob, meta, S, du, starts)
               if S < R else None)
        data = (_device_decode(blob, meta, S, starts, dev) if S
                else b"") + (fut.result() if fut else b"")
    if verify:
        container.verify_crc(data, meta)
    return data
