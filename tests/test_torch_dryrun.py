"""`python -m mhc_tpu_torch.parallel.dryrun`, the port's N-rank check of
the sharded pipeline: it runs on the cards unless `--device cpu` names
the CPU, so without a card and without `--device` it exits non-zero
before it spawns a rank; with `--device cpu` two gloo ranks pass."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dryrun(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "mhc_tpu_torch.parallel.dryrun", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def test_dryrun_refuses_without_a_card():
    # an empty CUDA_VISIBLE_DEVICES hides any card from this process
    r = _dryrun("--ranks", "2", env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert "dryrun(" not in r.stdout        # no rank ran
    r = _dryrun("--device", "cpu", "--backend", "nccl")
    assert r.returncode != 0 and "NCCL" in r.stderr


def test_dryrun_two_gloo_ranks_on_the_cpu():
    r = _dryrun("--ranks", "2", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dryrun(2, gloo, cpu): ok" in r.stdout
    assert "2 MB sharded container byte-identical" in r.stdout
