"""Command-line interface of the port: the flags and output of
`mhc_tpu/cli.py`, with `--device` in place of JAX's platform setting.

    python -m mhc_tpu_torch.cli encode --mode markov --block-size 64K IN OUT
    python -m mhc_tpu_torch.cli decode IN OUT
    python -m mhc_tpu_torch.cli stat IN          (inspect a container)
    torchrun --nproc-per-node N -m mhc_tpu_torch.cli encode --distributed IN OUT

`--device` defaults to the first CUDA card; without one the command
fails unless `--device cpu` names the CPU (the plain PyTorch versions of
the kernels). `--sharded` runs the data-parallel pipeline
(`parallel/pipeline.py`) over the initialised `torch.distributed` world,
or a world of one; `--distributed` first joins the world torchrun
describes (`parallel.mesh.init_distributed`: NCCL on CUDA, gloo with
`--device cpu`) and implies `--sharded`. Every rank reads the input and
each node's local rank 0 writes the output. The reference's
`decode --decode-method` chose between TPU decoders and is not ported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    for suffix, m in (("K", 1024), ("M", 1024 ** 2), ("G", 1024 ** 3)):
        if s.endswith(suffix):
            s, mult = s[:-1], m
            break
    return int(float(s) * mult)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mhc", description="Markov-Huffman codec on a CUDA GPU")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="compress a file")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument("--mode", default="markov",
                    choices=["markov", "huffman", "order0"])
    pe.add_argument("--block-size", default="64K", type=_parse_size)
    pe.add_argument("--decode-unit", default=None, type=_parse_size,
                    help="independent decode granularity (default 8K "
                    "markov, 16K order-0; power of two dividing "
                    "block-size)")
    pe.add_argument("--no-crc", action="store_true")
    pe.add_argument("--segment-size", default="1G", type=_parse_size,
                    help="stream files in independent segments (bounds "
                    "memory; multi-GB inputs become chained containers)")
    pe.add_argument("--host-fraction", default=None, type=float,
                    help="hybrid executor: share of units encoded by "
                    "host C++ threads (0..1; containers are identical)")
    pe.add_argument("--report", action="store_true",
                    help="print a JSON size/throughput report")

    pd = sub.add_parser("decode", help="decompress a file")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.add_argument("--no-verify", action="store_true")
    pd.add_argument("--host-fraction", default=None, type=float,
                    help="hybrid executor: share of units decoded by "
                    "host C++ threads (0..1)")
    pd.add_argument("--report", action="store_true")

    for sp in (pe, pd):
        sp.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card; "
                        "'cpu' runs the plain PyTorch versions)")
        sp.add_argument("--sharded", action="store_true",
                        help="data-parallel over the ranks of the "
                        "torch.distributed world (a world of one when "
                        "none is initialised)")
        sp.add_argument("--distributed", action="store_true",
                        help="join the world torchrun describes first "
                        "(NCCL on CUDA, gloo on the CPU); implies "
                        "--sharded")

    ps = sub.add_parser("stat", help="inspect a container header")
    ps.add_argument("input")

    args = p.parse_args(argv)

    from . import api, container  # deferred: importing torch is slow

    try:
        return _run(args, api, container)
    except (ValueError, OSError, RuntimeError) as e:
        print(f"mhc: error: {e}", file=sys.stderr)
        return 1


def _run(args, api, container) -> int:
    if args.cmd == "stat":
        with open(args.input, "rb") as f:
            meta = container.parse_container(f.read())
        print(json.dumps({
            "mode": ("markov" if meta.mode == container.MODE_MARKOV
                     else "huffman"),
            "orig_len": meta.orig_len,
            "block_size": meta.block_size,
            "decode_unit": meta.decode_unit or meta.block_size,
            "n_blocks": meta.n_blocks,
            "n_units": len(meta.byte_lengths),
            "crc32": meta.crc32,
            "payload_bytes": int(meta.byte_lengths.sum()),
            "index_bytes": meta.index_bytes,
            "table_bytes": meta.payload_off - 24 - meta.index_bytes,
            "header_bytes": 24,
            "container_bytes": container.container_size(meta),
        }))
        return 0

    from .config import resolve_device
    mesh = None
    if args.distributed:
        from .parallel.mesh import init_distributed
        mesh = init_distributed(args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    sharded = args.sharded or args.distributed

    if args.cmd == "encode":
        t0 = time.perf_counter()
        rep = api.compress_file(
            args.input, args.output, mode=args.mode,
            block_size=args.block_size, decode_unit=args.decode_unit,
            crc=not args.no_crc, segment_size=args.segment_size,
            sharded=sharded, mesh=mesh, host_fraction=args.host_fraction,
            device=device)
        dt = time.perf_counter() - t0
        if args.report:
            rep["encode_seconds"] = dt
            rep["encode_MBps"] = rep["orig_bytes"] / dt / 1e6 if dt else None
            print(json.dumps(rep))
        else:
            print(f"{args.input}: {rep['orig_bytes']} -> "
                  f"{rep['compressed_bytes']} bytes "
                  f"({rep['ratio']:.4f}) in {dt:.3f}s")
        return 0

    t0 = time.perf_counter()
    rep = api.decompress_file(
        args.input, args.output, verify=not args.no_verify,
        sharded=sharded, mesh=mesh, host_fraction=args.host_fraction,
        device=device)
    dt = time.perf_counter() - t0
    if args.report:
        rep["decode_seconds"] = dt
        rep["decode_MBps"] = rep["orig_bytes"] / dt / 1e6 if dt else None
        print(json.dumps(rep))
    else:
        print(f"{args.input}: -> {rep['orig_bytes']} bytes in {dt:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
