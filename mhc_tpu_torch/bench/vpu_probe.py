"""Time the one-hot and pick building blocks of the reference's fetch
kernels on a CUDA card, and the fetch itself as a one-hot product on the
tensor cores (P3, the counterpart of the reference's bench/vpu_probe.py).

    python -m mhc_tpu_torch.bench.vpu_probe [ITERS] [--device cuda:0 | cpu]

Runs kernel P3 (csrc/probes.cu, the loop inside one launch, the 1,024
carries spread over the card) over a (8, 128) int32 carry in [0, 256)
for ITERS steps (default 1,024): a null loop (a thread a carry); three
one-hot builds (int32 compare with an int8 cast, bf16, a 16 x 16 int8
outer product), each with a 256-deep pick; four 256-deep picks from a
table in shared memory (int32, int8 products summed in int32 or int8,
float32) on the CUDA cores, a warp a carry, each lane 8 of the 256
terms; and two fetch cores, ITERS // 4 steps each, whose one-hot of the
carry is multiplied by a (256, 316) int8 or bf16 plane on wgmma, 8
carries a CTA, rows 0..15 summed. Each body: one
warm-up run, then the minimum of 3, each between CUDA events; `chk` is
the sum of its (8, 128) result. One JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.kernels import _build
from . import probes


def run(device: torch.device, iters: int = probes.VPU_ITERS) -> dict:
    """Every P3 body for the probe's `iters` on `device`: the JSON line's
    dict."""
    before = dict(_build.LAUNCHES)
    res = {"iters": iters, **probes.device_fields(device)}
    x = probes.vpu_input(device)
    for name in probes.VPU_BODIES:
        operand = probes.vpu_operand(name, device)
        steps = probes.vpu_steps(name, iters)
        out, s = probes.best_seconds(
            lambda: probes.vpu_probe(name, x, steps, operand), device)
        res[name] = {"s": s, "us_per_iter": s / max(steps, 1) * 1e6,
                     "chk": int(out.long().sum())}
    res["launches"] = probes.launches_since(before, "vpu_probe/")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("iters", nargs="?", type=int, default=probes.VPU_ITERS,
                   help="steps of each loop (the fetch cores run a quarter)")
    p.add_argument("--device", default=None,
                   help="cuda:N (default: the first card; exit 1 without "
                        "one) or cpu (the plain versions)")
    args = p.parse_args(argv)
    print(json.dumps(run(probes.resolve("vpu_probe", args.device),
                         args.iters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
