"""Public single-process API: compress / decompress.

Counterpart of `mhc_tpu/api.py`: thin wrappers over the device engine
and the container, for both modes. The reference's chunked host<->device
overlap, segment chaining and file APIs are not ported yet (ROADMAP item
8); here the whole input is staged at once.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from . import container
from .config import resolve_device
from .models.entropy import get_model
from .ops.huffman import MAX_CODE_LEN

DEFAULT_BLOCK_SIZE = 64 * 1024
# Sequential decode length per stream: 8 KB units keep the 100 MB Markov
# container under the reference oracle's size while giving 8x the
# parallel streams of 64 KB blocks.
DEFAULT_DECODE_UNIT = 8192
DEFAULT_DECODE_UNIT_ORDER0 = 16384


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


def resolve_decode_unit(block_size: int, decode_unit: int | None,
                        markov: bool = True) -> int:
    """Clamp the decode unit to the block size; units must divide blocks."""
    du = decode_unit or (DEFAULT_DECODE_UNIT if markov
                         else DEFAULT_DECODE_UNIT_ORDER0)
    du = min(du, block_size)
    if block_size % du != 0 or du & (du - 1):
        raise ValueError(
            f"decode_unit {du} must be a power of two dividing "
            f"block_size {block_size}")
    # the u16 unit index requires a worst-case unit stream < 64 KB
    if du != block_size and du * MAX_CODE_LEN // 8 >= (1 << 16):
        raise ValueError(f"decode_unit {du} too large for u16 unit index")
    return du


def compress(data: bytes, mode: str = "markov",
             block_size: int = DEFAULT_BLOCK_SIZE, crc: bool = True,
             decode_unit: int | None = None, device=None,
             pack_method: str | None = None) -> bytes:
    """Input bytes -> MHTC container, coded on `device` (None: the first
    CUDA card; raises without one — pass "cpu" for the plain versions).
    `pack_method` is "fused" (None, K3) or "dense" (K5 then K4); both
    write the same bytes."""
    from . import engine
    model = get_model(mode)
    pack_method = engine.check_pack_method(pack_method)
    if block_size & (block_size - 1):
        raise ValueError("block_size must be a power of two")
    du = resolve_decode_unit(block_size, decode_unit, model.markov)
    checksum = (zlib.crc32(data) & 0xFFFFFFFF) if crc else None
    if len(data) == 0:
        return container.build_container(
            model.mode, 0, block_size,
            np.zeros((256, 256) if model.markov else (256,), np.uint8),
            np.zeros((0,), np.int64), b"", checksum, decode_unit=du)
    st = engine.stage(data, mode, block_size, du, device)
    return engine.assemble_container(
        engine.encode(st, pack_method=pack_method), checksum)


def decompress(blob: bytes, verify: bool = True, device=None) -> bytes:
    """MHTC container of either mode and either payload layout ->
    original bytes, decoded on `device` (None: the first CUDA card;
    raises without one)."""
    from . import engine
    meta = container.parse_container(blob)
    model = get_model(meta.mode)
    if meta.orig_len == 0:
        return b""
    dev = resolve_device(device)
    du = meta.decode_unit or meta.block_size
    R = len(meta.byte_lengths)
    if R != -(-meta.orig_len // du):
        raise ValueError("mhc: corrupt container (unit count)")
    aligned = bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD)
    total = int(meta.byte_lengths.sum())
    if aligned:
        words = np.frombuffer(blob, dtype=">u4", count=total // 4,
                              offset=meta.payload_off).astype(np.uint32)
        payload = torch.from_numpy(words.view(np.int32))
    else:
        payload = torch.from_numpy(np.frombuffer(
            blob, dtype=np.uint8, count=total,
            offset=meta.payload_off).copy())
    enc = engine.EncodeResult(
        mode=model.name, block_size=meta.block_size, decode_unit=du,
        orig_len=meta.orig_len, n_units=R, lengths=meta.lengths,
        byte_lens=meta.byte_lengths, bit_lens=None, payload=payload.to(dev),
        raw_units=bool(meta.flags & container.FLAG_RAW_UNITS),
        aligned=aligned)
    data = engine.fetch_bytes(enc, engine.decode(enc))
    if verify:
        container.verify_crc(data, meta)
    return data
