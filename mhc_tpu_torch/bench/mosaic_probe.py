"""Two capability probes on a CUDA card (P2, the counterpart of the
reference's bench/mosaic_probe.py):

  1. an int8 x int8 -> int32 product inside a kernel, on the tensor
     cores (wgmma m64n128k32), checked against an exact product;
  2. the port's Markov histogram kernel K1 against the reference's
     one-hot matmul histogram, on 16 MB of the benchmark corpus as 8 KB
     rows: equal counts, and the time of each.

    python -m mhc_tpu_torch.bench.mosaic_probe [--device cuda:0 | cpu]

Each timed call: one warm-up run, then the minimum of 3, each between
CUDA events. One JSON line, with the reference's keys (`hist_pallas_*`
is K1, the port's counterpart of the reference's Pallas histogram).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops.kernels import _build
from . import probes

CORPUS_BYTES = 16 << 20
ROW_BYTES = 8192


def run(device: torch.device, corpus_bytes: int = CORPUS_BYTES) -> dict:
    """Both probes on `device`: the JSON line's dict."""
    from ..ops import histogram
    from ..utils.corpus import make_corpus
    before = dict(_build.LAUNCHES)
    res = probes.device_fields(device)

    a, b = probes.i8_matmul_inputs(device)
    out, s = probes.best_seconds(lambda: probes.i8_matmul(a, b), device)
    exact = a.cpu().numpy().astype(np.int64) @ b.cpu().numpy().astype(
        np.int64)
    res["i8_matmul"] = bool((out.cpu().numpy() == exact).all())
    res["i8_matmul_s"] = s

    data = np.frombuffer(make_corpus(corpus_bytes)[:corpus_bytes],
                         np.uint8).reshape(-1, ROW_BYTES)
    units = torch.from_numpy(data.copy()).to(device)
    n_valid = torch.full((units.shape[0],), ROW_BYTES, dtype=torch.int32,
                         device=device)
    ref, res["hist_matmul_s"] = probes.best_seconds(
        lambda: probes.markov_hist_matmul(units, n_valid), device)
    got, res["hist_pallas_s"] = probes.best_seconds(
        lambda: histogram.histogram_markov(units, n_valid), device)
    res["hist_pallas_ok"] = bool(torch.equal(got, ref.to(got.dtype)))
    res["hist_rows"] = list(units.shape)
    res["launches"] = probes.launches_since(before, "mosaic_probe/",
                                            "markov_hist")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda:N (default: the first card; exit 1 without "
                        "one) or cpu (the plain versions)")
    args = p.parse_args(argv)
    print(json.dumps(run(probes.resolve("mosaic_probe", args.device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
