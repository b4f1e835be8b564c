"""Public API: compress / decompress of host bytes, and files.

Counterpart of `mhc_tpu/api.py`, for both modes. The input is cut into
chunks of whole decode units (`CHUNK_BYTES`), and each chunk runs
through the device-resident engine:

  compress:   pass 1: copy every chunk to the device and histogram it,
              the counts summed on the device -> one host table build ->
              pass 2: per chunk lookup+pack, literal substitution and
              compaction (engine.encode), the payload copied back ->
              container
  decompress: container -> per chunk: payload copied to the device,
              expansion, decode, literal overwrite (engine.decode), the
              bytes copied back -> crc check

On a CUDA device every copy goes through a pinned host buffer on a side
stream, ordered against the compute stream by events, so one chunk's
copy overlaps another chunk's kernels. The container does not depend on
the chunking. `compress_file` / `decompress_file` chain independent
containers for files larger than a segment; `host_fraction` sends a
share of the units to host C++ threads (`hybrid.py`).

Not ported: the reference's d2h split into sub-buffers (`_fetch_subs`,
`_split_flat`: a workaround for its relay), its `MHC_ENC_FETCH` variants
and its Mosaic compile-error fallback. There is one path: compaction on
the device, then one copy of the dense payload.
"""

from __future__ import annotations

import os
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
# Input bytes per chunk of compress / decompress (rounded down to whole
# decode units). The reference's 16 MB came from TPU VMEM and compile
# limits. Here the decode kernel runs one thread per unit and the pack
# kernels one warp, so a chunk is as many threads or warps as units (16
# MB of 8 KB units: 2,048), and each chunk costs the kernels' full
# serial chain and a table build: larger chunks fill more SMs, smaller
# ones overlap more copying with kernels. On an H100 (PERF.md), 64 MB
# was the fastest of 16 to 96 MB at 100 MB of input, in both modes and
# directions but one, where it was within 4%.
CHUNK_BYTES = 64 << 20
# A file larger than a segment is stored as a chain of independent
# containers: bounds host and device memory, and keeps every context's
# histogram total within int32 (ops/huffman.py).
DEFAULT_SEGMENT_SIZE = 1 << 30


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


def _chunks(n_units: int, du: int):
    """[lo, hi) unit ranges of CHUNK_BYTES each (at least one unit)."""
    C = max(1, CHUNK_BYTES // du)
    return [(lo, min(lo + C, n_units)) for lo in range(0, n_units, C)]


class _Copier:
    """The host<->device copies of one call. On a CUDA device they run on
    a side stream from and to pinned host buffers, ordered against the
    compute stream by events; on the CPU the host buffer is the tensor."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(dev)
            self.side = torch.cuda.Stream(dev)

    def staging(self, shape, dtype) -> torch.Tensor:
        """An empty host buffer for the caller to fill, then copy with
        `start_to_device`."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def start_to_device(self, host: torch.Tensor):
        """Start copying a filled staging buffer to the device; `ready()`
        of the result hands the copy to the compute stream. The caching
        host allocator holds the pinned buffer until the copy has run."""
        if not self.cuda:
            return host, None
        with torch.cuda.stream(self.side):
            out = torch.empty(host.shape, dtype=host.dtype, device=self.dev)
            out.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.side)
        return out, done

    def ready(self, handle) -> torch.Tensor:
        """The device copy, the compute stream's next work ordered after
        that copy alone (not after copies started later)."""
        out, done = handle
        if done is not None:
            self.compute.wait_event(done)
            out.record_stream(self.compute)
        return out

    def start_to_host(self, t: torch.Tensor):
        """Start copying `t`, once the compute stream's work so far has
        run; `host()` of the result waits for the copy."""
        if not self.cuda:
            return t, None
        self.side.wait_stream(self.compute)
        with torch.cuda.stream(self.side):
            pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            pinned.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.side)
        t.record_stream(self.side)
        return pinned, done

    @staticmethod
    def host(handle) -> np.ndarray:
        pinned, done = handle
        if done is not None:
            done.synchronize()
        return pinned.numpy()


def _empty_container(model, block_size: int, du: int, checksum) -> bytes:
    return container.build_container(
        model.mode, 0, block_size,
        np.zeros((256, 256) if model.markov else (256,), np.uint8),
        np.zeros((0,), np.int64), b"", checksum, decode_unit=du)


def compress(data: bytes, mode: str = "markov",
             block_size: int = DEFAULT_BLOCK_SIZE, crc: bool = True,
             decode_unit: int | None = None, device=None,
             pack_method: str | None = None) -> bytes:
    """Input bytes -> MHTC container, coded on `device` (None: the first
    CUDA card; raises without one — pass "cpu" for the plain versions).
    `pack_method` is "fused" (None, K3), "dense" (K5 then K4) or
    "pallas" (K5 then K6); all write the same bytes."""
    from . import engine
    model = get_model(mode)
    pack_method = engine.check_pack_method(pack_method)
    if block_size & (block_size - 1):
        raise ValueError("block_size must be a power of two")
    du = resolve_decode_unit(block_size, decode_unit, model.markov)
    if len(data) == 0:
        return _empty_container(model, block_size, du,
                                zlib.crc32(b"") if crc else None)
    dev = resolve_device(device)
    flat = np.frombuffer(data, dtype=np.uint8)
    n = flat.size
    copier = _Copier(dev)
    # pass 1: every chunk to the device, its histogram added on the device
    staged, counts = [], None
    for lo, hi in _chunks(-(-n // du), du):
        seg = flat[lo * du: hi * du]
        units = copier.staging((hi - lo, du), torch.uint8)
        u = units.numpy().reshape(-1)
        u[: seg.size] = seg
        u[seg.size:] = 0
        n_valid = copier.staging((hi - lo,), torch.int32)
        nv = n_valid.numpy()
        nv[:] = du
        nv[-1] = seg.size - (hi - lo - 1) * du
        st = engine.Staged(
            mode=model.name, block_size=block_size, decode_unit=du,
            orig_len=seg.size, n_units=hi - lo,
            units=copier.ready(copier.start_to_device(units)),
            n_valid=copier.ready(copier.start_to_device(n_valid)))
        c = model.histogram(st.units, st.n_valid)
        counts = c if counts is None else counts + c
        staged.append(st)
    # the host's checksum runs while the device works through pass 1
    checksum = (zlib.crc32(data) & 0xFFFFFFFF) if crc else None
    lengths = model.lengths_from_counts(
        counts.cpu().numpy().astype(np.int64))
    # pass 2: pack and compact each chunk; the copy of its payload to the
    # host overlaps the next chunk's kernels
    payload, bit_lens, pending = [], [], []

    def finish(enc, handle):
        payload.append(engine.payload_bytes(enc, copier.host(handle)))

    for st in staged:
        enc = engine.encode(st, lengths=lengths, pack_method=pack_method)
        bit_lens.append(enc.bit_lens)
        pending.append((enc, copier.start_to_host(engine.be_payload(enc))))
        if len(pending) > 1:
            finish(*pending.pop(0))
    for p in pending:
        finish(*p)
    return container.build_container(
        model.mode, n, block_size, lengths, np.concatenate(bit_lens),
        payload, checksum, decode_unit=du)


def decompress(blob: bytes, verify: bool = True, device=None) -> bytes:
    """MHTC container of either mode and either payload layout ->
    original bytes, decoded on `device` (None: the first CUDA card;
    raises without one)."""
    from . import engine
    from .ops import bitpack
    meta = container.parse_container(blob)
    model = get_model(meta.mode)
    if meta.orig_len == 0:
        return b""
    dev = resolve_device(device)
    du = meta.decode_unit or meta.block_size
    byte_lens = meta.byte_lengths.astype(np.int64)
    R = len(byte_lens)
    if R != -(-meta.orig_len // du):
        raise ValueError("mhc: corrupt container (unit count)")
    aligned = bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD)
    # before any upload or allocation
    engine.check_unit_lengths(byte_lens, du, aligned)
    starts = meta.payload_off + np.concatenate(
        [[0], np.cumsum(byte_lens)]).astype(np.int64)
    src = np.frombuffer(blob, dtype=np.uint8)
    copier = _Copier(dev)
    out, pending = [], []

    def upload(lo, hi):
        a, b = int(starts[lo]), int(starts[hi])
        host = copier.staging((b - a,), torch.uint8)
        host.numpy()[:] = src[a:b]
        return copier.start_to_device(host)

    def finish(enc, handle):
        # a view of the host buffer: the one copy is the join below
        out.append(copier.host(handle).reshape(-1)[: enc.orig_len])

    chunks = _chunks(R, du)
    upload_next = upload(*chunks[0])
    for i, (lo, hi) in enumerate(chunks):
        payload = copier.ready(upload_next)
        # the next chunk's copy runs beside this chunk's kernels
        if i + 1 < len(chunks):
            upload_next = upload(*chunks[i + 1])
        enc = engine.EncodeResult(
            mode=model.name, block_size=meta.block_size, decode_unit=du,
            orig_len=min(hi * du, meta.orig_len) - lo * du, n_units=hi - lo,
            lengths=meta.lengths, byte_lens=byte_lens[lo:hi], bit_lens=None,
            payload=(bitpack.be_bytes_to_words(payload) if aligned
                     else payload),
            raw_units=bool(meta.flags & container.FLAG_RAW_UNITS),
            aligned=aligned)
        pending.append((enc, copier.start_to_host(engine.decode(enc))))
        if len(pending) > 1:
            finish(*pending.pop(0))
    for p in pending:
        finish(*p)
    data = b"".join(out)
    if verify:
        container.verify_crc(data, meta)
    return data


def compress_file(in_path: str, out_path: str, mode: str = "markov",
                  block_size: int = DEFAULT_BLOCK_SIZE,
                  decode_unit: int | None = None, crc: bool = True,
                  segment_size: int = DEFAULT_SEGMENT_SIZE,
                  sharded: bool = False, host_fraction: float | None = None,
                  device=None) -> dict:
    """Streaming file compression with segment chaining; returns stats.
    `host_fraction` routes that share of each segment's units to the
    hybrid host/device executor; the containers are the same either way."""
    if sharded:
        raise NotImplementedError(
            "sharded compression is multi-GPU, ROADMAP.md item 11, not "
            "ported yet")
    total_in = os.path.getsize(in_path)
    total_out = 0
    n_segments = 0
    with open(in_path, "rb") as f, open(out_path, "wb") as out:
        while True:
            seg = f.read(segment_size)
            if not seg and n_segments > 0:
                break
            if host_fraction is not None:
                from . import hybrid
                blob = hybrid.compress(
                    seg, mode=mode, block_size=block_size, crc=crc,
                    decode_unit=decode_unit, host_fraction=host_fraction,
                    device=device)
            else:
                blob = compress(seg, mode=mode, block_size=block_size,
                                crc=crc, decode_unit=decode_unit,
                                device=device)
            out.write(blob)
            total_out += len(blob)
            n_segments += 1
            if len(seg) < segment_size:
                break
    return {"orig_bytes": total_in, "compressed_bytes": total_out,
            "ratio": total_out / max(total_in, 1),
            "n_segments": n_segments}


def _next_segment(f, buf: bytes) -> tuple[bytes | None, bytes]:
    """Read exactly one container from file f (with `buf` carried over
    from the previous read). Returns (segment bytes or None at EOF, new
    carry). Memory is bounded by one segment, never the whole file."""
    if not buf:
        buf = f.read(1 << 18)
        if not buf:
            return None, b""
    while True:
        try:
            meta = container.parse_container(buf, head_only=True)
            break
        except ValueError as e:
            if "truncated" not in str(e):
                raise
            more = f.read(max(len(buf), 1 << 18))
            if not more:
                raise
            buf += more
    size = container.container_size(meta)
    if len(buf) < size:
        rest = f.read(size - len(buf))
        if len(rest) != size - len(buf):
            raise ValueError("mhc: truncated container (payload)")
        return buf + rest, b""
    return buf[:size], buf[size:]


def decompress_file(in_path: str, out_path: str, verify: bool = True,
                    sharded: bool = False, host_fraction: float | None = None,
                    device=None) -> dict:
    """Streaming decompression of a (possibly segment-chained) file, one
    segment at a time."""
    if sharded:
        raise NotImplementedError(
            "sharded decompression is multi-GPU, ROADMAP.md item 11, not "
            "ported yet")
    total_out = 0
    n_segments = 0
    with open(in_path, "rb") as f, open(out_path, "wb") as out:
        carry = b""
        while True:
            seg, carry = _next_segment(f, carry)
            if seg is None:
                break
            if host_fraction is not None:
                from . import hybrid
                data = hybrid.decompress(seg, verify=verify,
                                         host_fraction=host_fraction,
                                         device=device)
            else:
                data = decompress(seg, verify=verify, device=device)
            out.write(data)
            total_out += len(data)
            n_segments += 1
    return {"orig_bytes": total_out, "n_segments": n_segments}


def compression_report(data: bytes, blob: bytes) -> dict:
    """Size accounting of one container."""
    meta = container.parse_container(blob)
    index_bytes = meta.index_bytes
    return {
        "orig_bytes": len(data),
        "compressed_bytes": len(blob),
        "ratio": len(blob) / max(len(data), 1),
        "payload_bytes": int(meta.byte_lengths.sum()),
        "table_bytes": meta.payload_off - 24 - index_bytes,
        "index_bytes": index_bytes,
        "header_bytes": 24,
        "n_blocks": meta.n_blocks,
        "n_units": len(meta.byte_lengths),
        "block_size": meta.block_size,
        "decode_unit": meta.decode_unit or meta.block_size,
        "mode": "markov" if meta.mode == container.MODE_MARKOV else "huffman",
    }
