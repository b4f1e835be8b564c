"""The sharded pipeline's check over N ranks.

The analogue of the reference's `__graft_entry__.py::dryrun_multichip`,
held against the port's own single-device path:

    python -m mhc_tpu_torch.parallel.dryrun --ranks 2                 # gloo, CPU
    python -m mhc_tpu_torch.parallel.dryrun --ranks 2 --backend nccl  # a card per rank

Each rank runs `dryrun(mesh)`: the tiny `encode_sharded` /
`decode_sharded` round trip (2 blocks per rank, a ragged tail); a 2 MB
`compress_sharded` equal to `api.compress` on the rank's device, and its
round trip; and the breadth cases, order-0 with a ragged final share and
Markov with decode_unit=2048, each equal to the single-device container
(flags included) and round-tripped. The ranks meet through a FileStore in
a temporary directory, so no port is opened.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import api, container
from ..utils.corpus import make_corpus
from . import pipeline
from .mesh import Mesh, make_mesh


def _say(mesh: Mesh, msg: str) -> None:
    if mesh.rank == 0:
        print(f"dryrun({mesh.world_size}): {msg}", flush=True)


def dryrun(mesh: Mesh) -> None:
    """Raises AssertionError where the sharded path differs from the
    single-device one."""
    W = mesh.world_size
    rng = np.random.default_rng(1)
    B, n = 2 * W, 512
    blocks = rng.integers(0, 64, (B, n), dtype=np.uint8)
    n_valid = np.full((B,), n, np.int32)
    n_valid[-1] = 100
    words, bits, lengths = pipeline.encode_sharded(blocks, n_valid, mesh)
    assert words.shape[0] == B and bits.shape == (B,) and (bits > 0).all()
    out = pipeline.decode_sharded(words, n_valid, lengths, mesh, n_out=n)
    for i in range(B):
        assert (out[i, : n_valid[i]] == blocks[i, : n_valid[i]]).all(), i
    _say(mesh, f"sharded round trip bit-exact ({B} blocks, "
         f"{int(bits.sum())} payload bits)")

    data = make_corpus(2 << 20)
    dev = mesh.device
    blob = pipeline.compress_sharded(data, mesh)
    assert blob == api.compress(data, device=dev), \
        "sharded container != single-device container"
    assert pipeline.decompress_sharded(blob, mesh) == data
    _say(mesh, f"2 MB sharded container byte-identical + round trip ok "
         f"({len(blob)} bytes)")

    ragged = data[: (1 << 20) + 37 * W + 13]
    for label, d, mode, du in (("order-0 ragged", ragged, "huffman", None),
                               ("markov du=2048", data[: 1 << 20], "markov",
                                2048)):
        sb = pipeline.compress_sharded(d, mesh, mode=mode, decode_unit=du)
        ub = api.compress(d, mode=mode, decode_unit=du, device=dev)
        assert sb == ub, f"sharded container != single-device ({label})"
        flags = container.parse_container(sb).flags
        assert flags == container.parse_container(ub).flags, label
        assert pipeline.decompress_sharded(sb, mesh) == d, label
        _say(mesh, f"{label} container byte-identical + round trip ok "
             f"({len(sb)} bytes, flags=0x{flags:02x})")


def _rank(rank: int, world: int, backend: str, store: str) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        dryrun(make_mesh(device))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--backend", choices=["gloo", "nccl"], default="gloo")
    args = p.parse_args(argv)
    if args.backend == "nccl" and args.ranks > torch.cuda.device_count():
        raise SystemExit(f"dryrun: {args.ranks} NCCL ranks need as many "
                         f"cards; this machine has "
                         f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank, args=(args.ranks, args.backend,
                         os.path.join(tmp, "store")), nprocs=args.ranks)
    print(f"dryrun({args.ranks}, {args.backend}): ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
