"""Stress the host library's loaders in a fresh checkout.

    python tests/native_race_stress.py TREE [ROUNDS]

TREE is a copy of the repo to spend (`git archive HEAD | tar -x -C
TREE`): each round deletes `TREE/native/libmhc_host.so` and `TREE/build/`,
then starts 6 loaders of the reference (`mhc_tpu.utils.native`) and 6 of
the port (`mhc_tpu_torch.utils.native`) at once, each printing True
once its library has loaded (the reference's `available()`; the port's
`require()` raises instead of returning without one), and counts those
that print anything but True. The
reference's loaders race each other on `native/libmhc_host.so` (its
`make -C native` rewrites the file in place); a port that builds its own
library elsewhere, atomically, loses none. One JSON line at the end.
"""

import json
import os
import shutil
import subprocess
import sys

LOADERS = {
    "reference": "from mhc_tpu.utils import native; print(native.available())",
    "port": ("from mhc_tpu_torch.utils import native; "
             "print(native.require() is not None)"),
}


def main(tree: str, rounds: int) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    false = dict.fromkeys(LOADERS, 0)
    total = dict.fromkeys(LOADERS, 0)
    for _ in range(rounds):
        so = os.path.join(tree, "native", "libmhc_host.so")
        if os.path.exists(so):
            os.remove(so)
        shutil.rmtree(os.path.join(tree, "build"), ignore_errors=True)
        procs = [(kind, subprocess.Popen(
            [sys.executable, "-c", code], cwd=tree, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True))
            for _ in range(6) for kind, code in LOADERS.items()]
        for kind, p in procs:
            total[kind] += 1
            false[kind] += p.communicate(timeout=600)[0].strip() != "True"
    return {"tree": tree, "rounds": rounds, "false": false, "of": total}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2
                          else 20)))
