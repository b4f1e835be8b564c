"""Public API: compress / decompress of host bytes, and files.

Counterpart of `mhc_tpu/api.py`, for both modes. The input is cut into
chunks of whole decode units (`CHUNK_BYTES`), and each chunk runs
through the device-resident engine:

  compress:   `encode_range` over all units: pass 1: copy every chunk
              to the device and histogram it, the counts summed on the
              device -> one table build of lengths and tables
              (`EntropyModel.tables_for`: one launch of the fused build
              on a card, the counts never fetched) ->
              pass 2: per chunk lookup+pack, literal substitution and
              compaction (engine.encode), the payload copied back ->
              container
  decompress: container -> `decode_range` over all units: per chunk,
              payload copied to the device, expansion, decode, literal
              rows (engine.decode), the bytes copied back -> crc
              check

On a CUDA device every copy goes through a pinned host buffer on a side
stream, ordered against the compute stream by events, so one chunk's
copy overlaps another chunk's kernels. The container does not depend on
the chunking. `compress_file` / `decompress_file` chain independent
containers for files larger than a segment; `host_fraction` sends a
share of the units to host C++ threads (`hybrid.py`), `sharded` splits
them over the ranks of a `torch.distributed` world
(`parallel/pipeline.py`), whose ranks each run `encode_range` and
`decode_range` on their share.

Each step of a call is a span (`utils.metrics.span`): `mhc.api.compress`
/ `mhc.api.decompress` around the call, and inside it the phases
compress: `blockify` (filling the staging buffers), `h2d`, `tables`
(the histograms and the table build), `crc32`, `pack` (`engine.encode`
of a chunk), `d2h` (the copy's start, then the wait for it and the
host's `join`, its cut to the container layout) and `container`;
decompress: `parse` (the container's parse and checks), `h2d`, `decode`
(`engine.decode` of a chunk: its tables, expansion, K7 and literal
rows, so the reference's decode-side `tables` and `expand` fall in
it), `d2h` (the waits and the `join`) and `crc32`, each
`mhc.api.<phase>`. No span synchronises the device: a phase's seconds
are the host's, and the device work it launched runs on. While a
`torch.profiler` runs, the spans are `record_function` ranges on its
clock, nested in the engine's (`mhc.engine.*`), the kernel launches'
(`mhc.launch.*`) and the host's waits for the device (`mhc.wait.*`), so
the device trace shows which step the card waited on;
`utils.metrics.tracing()` hands a caller the list of spans. With
`MHC_TRACE` set, `compress` and `decompress` each print one
`[mhc-trace compress] {json}` / `[mhc-trace decompress] {json}` line to
stderr, as the reference does: per phase its host seconds, bytes, GB/s
and calls, the reference's phases alone (no `parse`), recording into a
caller's `tracing()` where one is active. The reference's
`compact` and `marshal` have no stage of their own here.

Not ported: the reference's d2h split into sub-buffers (`_fetch_subs`,
`_split_flat`: a workaround for its relay), its `MHC_ENC_FETCH` variants
and its Mosaic compile-error fallback. There is one path: compaction on
the device, then one copy of the dense payload.
"""

from __future__ import annotations

import os
import sys
import zlib
from contextlib import contextmanager

import numpy as np
import torch

from . import container, engine
from .config import resolve_device
# the unit layout's parameters and check, also public here
from .container import (DEFAULT_BLOCK_SIZE, DEFAULT_DECODE_UNIT,
                        DEFAULT_DECODE_UNIT_ORDER0, blockify,
                        resolve_decode_unit)
from .models.entropy import get_model
from .ops import bitpack
from .ops.huffman import MAX_CODE_LEN
from .utils.metrics import span, tracing

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
# containers: bounds host and device memory.
DEFAULT_SEGMENT_SIZE = 1 << 30


@contextmanager
def _call(what: str, nbytes: int):
    """The span `mhc.api.<what>` of one call. With `MHC_TRACE` set, its
    spans are recorded (into the caller's `tracing()` where one is
    active) and its phases printed as one `[mhc-trace <what>] {json}`
    line to stderr."""
    if not os.environ.get("MHC_TRACE"):
        with span(f"mhc.api.{what}", nbytes):
            yield
        return
    with tracing(join=True) as tr, span(f"mhc.api.{what}", nbytes) as i:
        yield
    print(f"[mhc-trace {what}] {tr.dumps(omit=('parse',), root=i)}",
          file=sys.stderr)


def _chunks(lo: int, hi: int, du: int):
    """[a, b) unit ranges of CHUNK_BYTES each (at least one unit)
    covering [lo, hi)."""
    C = max(1, CHUNK_BYTES // du)
    return [(a, min(a + C, hi)) for a in range(lo, hi, C)]


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
        with span("mhc.wait.d2h"):
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
    with _call("compress", len(data)):
        model = get_model(mode)
        du = resolve_decode_unit(block_size, decode_unit, model.markov)
        pack_method = engine.check_pack_method(pack_method)
        if len(data) == 0:
            return _empty_container(model, block_size, du,
                                    zlib.crc32(b"") if crc else None)
        lengths, bit_lens, payload, checksum = encode_range(
            data, 0, -(-len(data) // du), model, block_size, du,
            resolve_device(device), pack_method, crc)
        with span("mhc.api.container", len(data)):
            return container.build_container(
                model.mode, len(data), block_size, lengths, bit_lens,
                payload, checksum, decode_unit=du)


def encode_range(data: bytes, lo: int, hi: int, model, block_size: int,
                 du: int, dev, pack_method: str = "fused", crc: bool = True,
                 reduce_counts=None):
    """Units [lo, hi) of `data` (units past its end are empty and code to
    no bits) through the engine on `dev`, in chunks of CHUNK_BYTES. Pass
    1 copies every chunk to the device and histograms it, the counts
    summed there in int64 and handed to `reduce_counts` (None: kept as
    they are; the sharded pipeline sums them over its ranks), then one
    table build (`EntropyModel.tables_for`); pass 2 packs each chunk
    with those lengths and tables
    and copies its payload back. Returns (host uint8 lengths, (hi - lo,)
    int64 bit lengths, the container-layout payload in pieces, the crc32
    of all of `data` or None)."""
    flat = np.frombuffer(data, dtype=np.uint8)
    n = flat.size
    copier = _Copier(dev)
    staged, counts = [], None
    for a, b in _chunks(lo, hi, du):
        seg = flat[min(a * du, n): min(b * du, n)]
        with span("mhc.api.blockify", seg.size):
            units = copier.staging((b - a, du), torch.uint8)
            u = units.numpy().reshape(-1)
            u[: seg.size] = seg
            u[seg.size:] = 0
            n_valid = copier.staging((b - a,), torch.int32)
            n_valid.numpy()[:] = np.clip(n - np.arange(a, b) * du, 0, du)
        with span("mhc.api.h2d", units.numel() + 4 * n_valid.numel()):
            st = engine.Staged(
                mode=model.name, block_size=block_size, decode_unit=du,
                orig_len=seg.size, n_units=b - a,
                units=copier.ready(copier.start_to_device(units)),
                n_valid=copier.ready(copier.start_to_device(n_valid)))
        with span("mhc.api.tables", seg.size):
            c = model.histogram(st.units, st.n_valid).long()
            counts = c if counts is None else counts + c
        staged.append(st)
    # the host's checksum runs while the device works through pass 1
    with span("mhc.api.crc32", n):
        checksum = (zlib.crc32(data) & 0xFFFFFFFF) if crc else None
    with span("mhc.api.tables"):
        if reduce_counts is not None:
            counts = reduce_counts(counts)
        lengths, tables = model.tables_for(counts, dev)
    # pass 2: pack and compact each chunk; the copy of its payload to the
    # host overlaps the next chunk's kernels
    payload, bit_lens, pending = [], [], []

    def finish(enc, handle):
        with span("mhc.api.d2h"):
            be = copier.host(handle)
            with span("mhc.api.join"):
                payload.append(engine.payload_bytes(enc, be))

    for st in staged:
        with span("mhc.api.pack", st.orig_len):
            enc = engine.encode(st, lengths=lengths, tables=tables,
                                pack_method=pack_method)
            be = engine.be_payload(enc)
        bit_lens.append(enc.bit_lens)
        with span("mhc.api.d2h", be.numel()):
            pending.append((enc, copier.start_to_host(be)))
        del be
        if len(pending) > 1:
            finish(*pending.pop(0))
    for p in pending:
        finish(*p)
    return enc.lengths, np.concatenate(bit_lens), payload, checksum


def parsed_chunk(meta, lo: int, hi: int, payload: torch.Tensor):
    """The engine's view of units [lo, hi) of a parsed container, given
    their payload bytes (uint8, on the decoding device) as stored."""
    du = meta.decode_unit or meta.block_size
    aligned = bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD)
    return engine.EncodeResult(
        mode=get_model(meta.mode).name, block_size=meta.block_size,
        decode_unit=du, orig_len=min(hi * du, meta.orig_len) - lo * du,
        n_units=hi - lo, lengths=meta.lengths,
        byte_lens=meta.byte_lengths[lo:hi].astype(np.int64), bit_lens=None,
        payload=bitpack.be_bytes_to_words(payload) if aligned else payload,
        raw_units=bool(meta.flags & container.FLAG_RAW_UNITS),
        aligned=aligned)


def check_parsed(meta) -> tuple:
    """(decode unit, per-unit stored bytes, payload start of each unit
    and of the end) of a parsed container with data, after the checks
    that every decode route (this module's, the files', the sharded and
    the hybrid one) runs before anything is sized by its header or
    index. A block size of 0, and in the substream layout a unit that no
    writer of either package emits (not under the block, under 4 bytes,
    or too long for the u16 index: `resolve_decode_unit`'s bounds),
    raise ValueError."""
    if meta.block_size == 0:
        raise ValueError("mhc: corrupt container (block size)")
    du = meta.decode_unit or meta.block_size
    if meta.decode_unit is not None and (
            not 4 <= du < meta.block_size
            or du * MAX_CODE_LEN // 8 >= 1 << 16):
        raise ValueError("mhc: corrupt container (decode unit)")
    byte_lens = meta.byte_lengths.astype(np.int64)
    if len(byte_lens) != -(-meta.orig_len // du):
        raise ValueError("mhc: corrupt container (unit count)")
    engine.check_unit_lengths(
        byte_lens, du, bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD),
        meta.orig_len)
    starts = meta.payload_off + np.concatenate(
        [[0], np.cumsum(byte_lens)]).astype(np.int64)
    return du, byte_lens, starts


def decompress(blob: bytes, verify: bool = True, device=None) -> bytes:
    """MHTC container of either mode and either payload layout ->
    original bytes, decoded on `device` (None: the first CUDA card;
    raises without one)."""
    with _call("decompress", len(blob)):
        with span("mhc.api.parse", len(blob)):
            meta = container.parse_container(blob)
            if meta.orig_len:
                dev = resolve_device(device)
                # before any upload or allocation
                _, byte_lens, starts = check_parsed(meta)
        if meta.orig_len == 0:
            # an orig_len rewritten to 0 still meets the crc of the bytes
            if verify:
                container.verify_crc(b"", meta)
            return b""
        data = decode_range(blob, meta, starts, 0, len(byte_lens), dev)
        with span("mhc.api.crc32", len(data)):
            if verify:
                container.verify_crc(data, meta)
        return data


def decode_range(blob: bytes, meta, starts: np.ndarray, lo: int, hi: int,
                 dev) -> bytes:
    """The original bytes of units [lo, hi) of a parsed container
    (`starts` from `check_parsed`), decoded on `dev` in chunks of
    CHUNK_BYTES: each chunk's payload copied to the device, decoded
    (engine.decode) and copied back, the next chunk's upload beside this
    chunk's kernels."""
    du = meta.decode_unit or meta.block_size
    chunks = _chunks(lo, hi, du)
    if not chunks:
        return b""
    src = np.frombuffer(blob, dtype=np.uint8)
    copier = _Copier(dev)
    out, pending = [], []

    def upload(a, b):
        start, end = int(starts[a]), int(starts[b])
        with span("mhc.api.h2d", end - start):
            host = copier.staging((end - start,), torch.uint8)
            host.numpy()[:] = src[start:end]
            return copier.start_to_device(host)

    def finish(enc, handle):
        # a view of the host buffer: the one copy is the join below
        with span("mhc.api.d2h"):
            out.append(copier.host(handle).reshape(-1)[: enc.orig_len])

    upload_next = upload(*chunks[0])
    for i, (a, b) in enumerate(chunks):
        payload = copier.ready(upload_next)
        # the next chunk's copy runs beside this chunk's kernels
        if i + 1 < len(chunks):
            upload_next = upload(*chunks[i + 1])
        enc = parsed_chunk(meta, a, b, payload)
        with span("mhc.api.decode", enc.orig_len):
            rows = engine.decode(enc)
        with span("mhc.api.d2h", rows.numel()):
            pending.append((enc, copier.start_to_host(rows)))
        del rows
        if len(pending) > 1:
            finish(*pending.pop(0))
    for p in pending:
        finish(*p)
    with span("mhc.api.d2h"), span("mhc.api.join"):
        return b"".join(out)


def _sharded_mesh(sharded: bool, mesh, host_fraction, device):
    """The mesh a sharded file call runs on (None when not sharded)."""
    if not sharded:
        return None
    if host_fraction is not None:
        raise ValueError("sharded and host_fraction are two executors for "
                         "one call; pass one")
    from .parallel.mesh import make_mesh
    return mesh or make_mesh(device)


def _output(path: str, mesh):
    """The output file, or a sink on the ranks of a sharded run other
    than each node's local rank 0: N ranks on a node share its paths."""
    if mesh is not None and mesh.local_rank != 0:
        return open(os.devnull, "wb")
    return open(path, "wb")


def compress_file(in_path: str, out_path: str, mode: str = "markov",
                  block_size: int = DEFAULT_BLOCK_SIZE,
                  decode_unit: int | None = None, crc: bool = True,
                  segment_size: int = DEFAULT_SEGMENT_SIZE,
                  sharded: bool = False, mesh=None,
                  host_fraction: float | None = None,
                  device=None) -> dict:
    """Streaming file compression with segment chaining; returns stats.
    `sharded` splits each segment's units over the ranks of `mesh`
    (None: `parallel.mesh.make_mesh(device)`, the initialised world or a
    world of one), every rank reading the input and local rank 0
    writing, each rank returning once the output is closed;
    `host_fraction` routes that share of each segment's units
    to the hybrid host/device executor. The containers are the same
    either way."""
    # the decode unit is checked before any file is opened
    resolve_decode_unit(block_size, decode_unit, get_model(mode).markov)
    mesh = _sharded_mesh(sharded, mesh, host_fraction, device)
    total_in = os.path.getsize(in_path)
    total_out = 0
    n_segments = 0
    with open(in_path, "rb") as f, _output(out_path, mesh) as out:
        while True:
            seg = f.read(segment_size)
            if not seg and n_segments > 0:
                break
            if sharded:
                from .parallel import pipeline
                blob = pipeline.compress_sharded(
                    seg, mesh, mode=mode, block_size=block_size, crc=crc,
                    decode_unit=decode_unit)
            elif host_fraction is not None:
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
    if mesh is not None:
        # every rank returns once local rank 0 has closed the output
        from .parallel import pipeline
        pipeline.barrier(mesh)
    return {"orig_bytes": total_in, "compressed_bytes": total_out,
            "ratio": total_out / max(total_in, 1),
            "n_segments": n_segments}


def _rest_of(f) -> int | None:
    """The bytes from f's position to its end (None: f is no file)."""
    if not hasattr(f, "fileno"):
        return None
    return os.fstat(f.fileno()).st_size - f.tell()


def _next_segment(f, buf: bytes) -> tuple[bytes | None, bytes]:
    """Read exactly one container from file f (with `buf` carried over
    from the previous read). Returns (segment bytes or None at EOF, new
    carry). Memory is bounded by one segment, never the whole file; the
    file's size bounds the header's claims."""
    if not buf:
        buf = f.read(1 << 18)
        if not buf:
            return None, b""
    while True:
        rest = _rest_of(f)
        try:
            meta = container.parse_container(
                buf, head_only=True,
                avail=None if rest is None else len(buf) + rest)
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
                    sharded: bool = False, mesh=None,
                    host_fraction: float | None = None,
                    device=None) -> dict:
    """Streaming decompression of a (possibly segment-chained) file, one
    segment at a time; `sharded` and `mesh` as in `compress_file`."""
    mesh = _sharded_mesh(sharded, mesh, host_fraction, device)
    total_out = 0
    n_segments = 0
    with open(in_path, "rb") as f, _output(out_path, mesh) as out:
        carry = b""
        while True:
            seg, carry = _next_segment(f, carry)
            if seg is None:
                break
            if sharded:
                from .parallel import pipeline
                data = pipeline.decompress_sharded(seg, mesh, verify=verify)
            elif host_fraction is not None:
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
