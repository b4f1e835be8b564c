"""Nothing the harness runs loads `jax`, `jaxlib`, `flax` or the JAX
package `mhc_tpu`, and the reference loads none of those nor the port
`mhc_tpu_torch`; top-level module names are compared whole."""

import ast
import os
import subprocess
import sys

from conftest import ROOT
from benchmark import harness

BENCH = os.path.join(ROOT, "benchmark")


def test_forbidden_modules_compares_top_level_names_whole():
    mods = ["mhc_tpu_torch", "mhc_tpu_torch.api", "mhc_tpu_torchx",
            "jaxtyping", "flaxen.x", "numpy"]
    assert harness.forbidden_modules(mods) == []
    bad = ["mhc_tpu", "mhc_tpu.api", "jax", "jax.numpy", "jaxlib.xla",
           "flax.linen"]
    assert harness.forbidden_modules(mods + bad) == sorted(bad)


def _loaded(code: str) -> set:
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r)\n" % ROOT + code
         + "\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return set(eval(r.stdout.strip().splitlines()[-1]))


def test_a_harness_run_loads_no_jax_nor_the_jax_package():
    top = _loaded(
        "import dataclasses, time\n"
        "from benchmark import harness\n"
        "for name in ('markov-64k.resident-100m', 'markov-64k.host-1m'):\n"
        "    c = harness.load_cell(name)\n"
        "    for tr, n in ((False, 40000), (True, 600)):\n"
        "        c = dataclasses.replace(c, traffic={**c.traffic,\n"
        "            'object_bytes': n, 'pool': 2,\n"
        "            'warmup_round_trips': 1, 'trace_round_trips': 1})\n"
        "        r = harness.run(c, 3, 0.05, tr, 'cpu', time.perf_counter())\n"
        "        assert r['correct'], r\n"
        "import runpy\n"
        "for f in ('control.py',):\n"
        "    runpy.run_path('benchmark/' + f)\n")
    assert "mhc_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "mhc_tpu"}


def test_the_reference_loads_numpy_and_the_standard_library_only():
    top = _loaded("import benchmark.reference.codec")
    assert not top & {"jax", "jaxlib", "flax", "mhc_tpu", "mhc_tpu_torch",
                      "torch"}


def test_the_reference_sources_import_nothing_of_the_program():
    allowed = {"__future__", "numpy", "os", "struct", "zlib",
               "concurrent"}
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (f, n)
