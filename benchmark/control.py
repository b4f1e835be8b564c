"""The control of a cell: the plain reference put in the program's place,
with one guarantee of the configuration broken, judged as a run judges
the program. It has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The traffic mix names the control (`control`: one of
`reference.codec.CONTROLS`): "no_literals" codes incompressible units
too (the container is no longer the format's exact bytes; the round trip
stays lossless), "no_crc" leaves the crc32 trailer out (nothing left for
decompress to verify). For each seed it makes the cell's pool, draws
the objects a run would judge (the sampler's slots: every object of a
pool no larger than the sample, else as many as the sample, from the
seed), writes each object's container with the control ("none": the
reference itself, which has to come out correct) and hands the
object itself back as the decoded bytes, then prints one JSON line:
the seed, `correct` and each number with its limit. It needs no card;
the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_run(cell, seed: int, control: str | None = None) -> dict:
    from benchmark import harness, inputs
    from benchmark.reference import codec
    cfg, traffic = cell.config, cell.traffic
    control = control or traffic["control"]
    # "none": the reference itself in the program's place
    variant = None if control == "none" else control
    pool = int(traffic["pool"])
    objects = inputs.pool(pool, int(traffic["object_bytes"]), seed,
                          traffic.get("kinds"))
    slots = max(1, min(int(traffic["sample"]), pool))
    rng = inputs.rng_for(seed, harness.SAMPLE_STREAM)
    picks = (list(range(pool)) if slots == pool
             else sorted(rng.choice(pool, slots, replace=False).tolist()))
    t = time.perf_counter()
    answers = [(k, codec.encode(objects[k], cfg["mode"], cfg["block_size"],
                                cfg["decode_unit"], crc=cfg["crc"],
                                control=variant),
                objects[k].tobytes()) for k in picks]
    control_s = time.perf_counter() - t
    checks, ref_s = harness.judge(answers, objects, cfg)
    return {"workload": cell.name, "seed": seed, "control": control,
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()},
            "control_s": control_s, "reference_s": ref_s}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(control_run(cell, seed, args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
