"""Calibrate a device loop on a CUDA card: the fixed cost of a step and
the cost of a dependent op (P1, the counterpart of the reference's
bench/loop_calib.py).

    python -m mhc_tpu_torch.bench.loop_calib [--device cuda:0 | cpu]

Runs kernel P1 (csrc/probes.cu, the loop inside one launch) over a
(8, 128) u32 carry for 4,096 steps: a chain of n dependent (c + k+1) ^
(c >> 1) a step for n in 4, 32, 128, 512, a shared-memory round trip, a
predicated store and a 64-deep masked sum. The 1,024 carries run in
one-warp blocks, a warp to an SM (the masked sum 8 lanes a carry), so
that each chain runs at its ops' latency; the round trip alone runs one
block of 1,024 threads, one SM's shared memory.
Fits ns per step = a + b * n over the four chains (a: the step's own
cost, b: the cost of one op), and times a one-op chain (c += c >> 1) at
two depths for an integer op's dependent latency. Each body: one warm-up
run, then the minimum of 3, each between CUDA events. One JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops.kernels import _build
from . import probes


def run(device: torch.device, iters: int = probes.LOOP_ITERS) -> dict:
    """Every P1 body for `iters` steps on `device`: the JSON line's dict."""
    before = dict(_build.LAUNCHES)
    res = {"iters": iters, **probes.device_fields(device)}
    x = probes.loop_input(device)
    for name in (*probes.LOOP_BODIES, *probes.DEP_BODIES):
        out, s = probes.best_seconds(
            lambda: probes.loop_calib(name, x, iters), device)
        res[name] = {"s": s, "ns_per_iter": s / max(iters, 1) * 1e9,
                     "chk": int(out.long().sum())}
    n = np.array([4, 32, 128, 512], dtype=np.float64)
    ns = np.array([res[f"chain_{k}"]["ns_per_iter"] for k in (4, 32, 128,
                                                               512)])
    b, a = np.polyfit(n, ns, 1)
    res["fit"] = {"a_ns_per_step": float(a), "b_ns_per_op": float(b)}
    res["int_dep_ns_per_op"] = ((res["dep1_512"]["ns_per_iter"]
                                 - res["dep1_32"]["ns_per_iter"]) / 480)
    res["launches"] = probes.launches_since(before, "loop_calib/")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda:N (default: the first card; exit 1 without "
                        "one) or cpu (the plain versions)")
    args = p.parse_args(argv)
    print(json.dumps(run(probes.resolve("loop_calib", args.device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
