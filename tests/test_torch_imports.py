"""mhc_tpu_torch imports torch and numpy, never JAX or the JAX package: a
fresh interpreter imports every module of the port and finds no `jax*`
and no `mhc_tpu` / `mhc_tpu.*` module loaded."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, json, pkgutil, sys
import mhc_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    mhc_tpu_torch.__path__, "mhc_tpu_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith("jax")
             or m == "mhc_tpu" or m.startswith("mhc_tpu."))
print(json.dumps({"imported": names, "forbidden": bad}))
'''


def test_the_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    for name in ("api", "engine", "cli", "hybrid", "serve", "utils.metrics",
                 "parallel.dryrun", "parallel.pipeline",
                 "models.entropy", "ops.kernels.huffman_cuda",
                 "ops.kernels.decode_cuda", "ops.kernels.probes_cuda",
                 "ops.kernels.tables_cuda", "ops.kernels.stages_cuda",
                 "bench.probes", "bench.loop_calib", "bench.mosaic_probe",
                 "bench.vpu_probe", "bench.multigb"):
        assert f"mhc_tpu_torch.{name}" in got["imported"], name
