"""Data-parallel sharded codec over the ranks of a `torch.distributed`
world (BASELINE.json:10-11).

Counterpart of `mhc_tpu/parallel/pipeline.py`, whose `shard_map` /
`psum` steps map onto ranks and collectives:

  two-pass global histogram  -> each rank histograms its share (K1 / K2),
                                then `all_reduce(SUM)` of the counts in
                                int64
  broadcast of shared tables -> none: every rank runs the table build
                                (on a card the fused build, K11 and K13
                                in one launch) on the identical counts,
                                so the tables are replicated by
                                determinism, as in the reference
  block-parallel encode /    -> each rank runs the engine on its units
  decode                        (the fused route, literal units where
                                decode_unit != block_size)
  ordered gather             -> `all_gather` of the per-rank bit lengths
                                (equal shapes), then of the payloads
                                (sizes first, then padded buffers), or of
                                the decoded rows, in rank order

Input contract (the reference's `pipeline.py:144-146`): every rank
passes the identical full input and gets the full container or the full
bytes back. The units are padded to a multiple of the world size; rank
r takes the r-th contiguous range (the reference's `P(axis)`), and the
padding units (n_valid 0) emit no bits and are trimmed. Each rank runs
its share through the single-device path's `api.encode_range` /
`api.decode_range` (chunks of `api.CHUNK_BYTES`, so its device memory
stays bounded; pinned copies on a side stream), the all-reduce hooked
in before the table build. Collective tensors live on the rank's card
under NCCL and on the CPU under gloo (CPU worlds, and ranks that share
one card).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.distributed as dist

from .. import api, container
from ..models.entropy import MARKOV, ORDER0, get_model
from ..ops.kernels import decode_cuda, encode_cuda
from .mesh import Mesh, make_mesh, pad_to_multiple


def _all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, on the rank's device."""
    if mesh.group is None:
        return t
    x = t.to(mesh.comm_device)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x.to(mesh.device)


def barrier(mesh: Mesh) -> None:
    """Returns on each rank once every rank has reached it: an all-reduce
    of one zero on the collectives' device, its result fetched (under
    NCCL the call alone would return before the other ranks join)."""
    _all_reduce_sum(mesh, torch.zeros(1, device=mesh.device)).cpu()


def _all_gather(mesh: Mesh, t: torch.Tensor) -> list:
    """Every rank's `t` (equal shapes), in rank order, on the
    communication device."""
    if mesh.group is None:
        return [t]
    x = t.to(mesh.comm_device).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.group)
    return parts


def _gather_bytes(mesh: Mesh, buf: bytes) -> bytes:
    """Every rank's bytes (any lengths) joined in rank order."""
    if mesh.group is None:
        return buf
    sizes = [int(s) for s in _all_gather(
        mesh, torch.tensor([len(buf)], dtype=torch.int64))]
    padded = torch.zeros(max(max(sizes), 1), dtype=torch.uint8)
    padded.numpy()[: len(buf)] = np.frombuffer(buf, np.uint8)
    parts = _all_gather(mesh, padded)
    return b"".join(p[:s].cpu().numpy().tobytes()
                    for p, s in zip(parts, sizes, strict=True))


def _share(n_units: int, mesh: Mesh) -> tuple[int, int]:
    """(first unit, units) of this rank's range of the units padded to a
    multiple of the world size."""
    per_rank = pad_to_multiple(max(n_units, 1), mesh.world_size) \
        // mesh.world_size
    return mesh.rank * per_rank, per_rank


def _my_rows(rows: np.ndarray, n_valid: np.ndarray, lo: int, count: int):
    """This rank's `count` rows of a host batch from row `lo`, and their
    valid counts; rows past the batch's end are zero, n_valid 0."""
    mine = np.zeros((count,) + rows.shape[1:], rows.dtype)
    nv = np.zeros(count, np.int32)
    real = max(0, min(len(rows) - lo, count))
    mine[:real], nv[:real] = rows[lo: lo + real], n_valid[lo: lo + real]
    return mine, nv


def encode_sharded(blocks: np.ndarray, n_valid: np.ndarray,
                   mesh: Mesh | None = None, markov: bool = True):
    """One sharded encode step over a host (B, n) uint8 block batch:
    histogram, all-reduce, the fused table build, K3 per rank, ordered gather. Returns host
    (words (B, W) int32, bits (B,) int32, lengths uint8)."""
    mesh = mesh or make_mesh()
    model = MARKOV if markov else ORDER0
    B = blocks.shape[0]
    mine, nv = _my_rows(blocks, n_valid, *_share(B, mesh))
    u = torch.from_numpy(mine).to(mesh.device)
    nv_d = torch.from_numpy(nv).to(mesh.device)
    # the replicated table build: the counts summed over the ranks in
    # int64, then built on every rank (the fused build on a card)
    lengths, t = model.tables_for(
        _all_reduce_sum(mesh, model.histogram(u, nv_d).long()), mesh.device)
    words, bits = encode_cuda.pack_units(u, nv_d, t["codes"], t["lengths"])
    words = torch.cat([w.cpu() for w in _all_gather(mesh, words)])[:B]
    bits = torch.cat([b.cpu() for b in _all_gather(mesh, bits)])[:B]
    return words.numpy(), bits.numpy(), lengths.cpu().numpy()


def decode_sharded(words: np.ndarray, n_valid: np.ndarray,
                   lengths: np.ndarray, mesh: Mesh | None, n_out: int,
                   markov: bool = True) -> np.ndarray:
    """Sharded decode of a host (B, W) int32 stream batch (each unit's
    stream from bit 0, zero-padded): K7 per rank on its rows, ordered
    gather. Returns host (B, n_out) uint8."""
    mesh = mesh or make_mesh()
    model = MARKOV if markov else ORDER0
    B = words.shape[0]
    mine, nv = _my_rows(words, n_valid, *_share(B, mesh))
    t = model.tables_from_lengths(lengths, mesh.device)
    out = decode_cuda.decode_units(
        torch.from_numpy(mine).to(mesh.device),
        torch.from_numpy(nv).to(mesh.device), t["lim"], t["base"],
        t["first_code"], t["sorted_syms"], n_out=n_out, markov=markov)
    return torch.cat([o.cpu() for o in _all_gather(mesh, out)])[:B].numpy()


def compress_sharded(data: bytes, mesh: Mesh | None = None,
                     mode: str = "markov",
                     block_size: int = api.DEFAULT_BLOCK_SIZE,
                     crc: bool = True, decode_unit: int | None = None,
                     device=None) -> bytes:
    """Two-pass sharded compress: the container `api.compress` writes for
    the same input and parameters. `mesh` None: `make_mesh(device)`."""
    model = get_model(mode)
    du = api.resolve_decode_unit(block_size, decode_unit, model.markov)
    n = len(data)
    if n == 0:
        return api._empty_container(model, block_size, du,
                                    zlib.crc32(b"") if crc else None)
    mesh = mesh or make_mesh(device)
    R = -(-n // du)
    lo, count = _share(R, mesh)
    lengths, bit_lens, payload, checksum = api.encode_range(
        data, lo, lo + count, model, block_size, du, mesh.device, crc=crc,
        reduce_counts=lambda c: _all_reduce_sum(mesh, c))
    bits = torch.cat([p.cpu() for p in _all_gather(
        mesh, torch.from_numpy(bit_lens))])[:R]
    return container.build_container(
        model.mode, n, block_size, lengths, bits.numpy(),
        _gather_bytes(mesh, b"".join(payload)), checksum, decode_unit=du)


def decompress_sharded(blob: bytes, mesh: Mesh | None = None,
                       verify: bool = True, device=None) -> bytes:
    """Sharded decode of a container of either mode and layout: each rank
    decodes its units, the bytes gathered in rank order; the unit lengths
    are checked before anything is sized."""
    meta = container.parse_container(blob)
    if meta.orig_len == 0:
        # an orig_len rewritten to 0 still meets the crc of the bytes
        if verify:
            container.verify_crc(b"", meta)
        return b""
    _, byte_lens, starts = api.check_parsed(meta)
    mesh = mesh or make_mesh(device)
    R = len(byte_lens)
    lo, count = _share(R, mesh)
    data = _gather_bytes(mesh, api.decode_range(
        blob, meta, starts, min(lo, R), min(lo + count, R), mesh.device))
    if verify:
        container.verify_crc(data, meta)
    return data
