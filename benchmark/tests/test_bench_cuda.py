"""On the card: a short run of a cell comes out correct, and a directory
that holds only BENCHMARK.json and the benchmark, without the program,
exits non-zero with no result line. Run with
`python -m pytest -m cuda benchmark/tests/test_bench_cuda.py`."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

pytestmark = pytest.mark.cuda


def _run(cwd, cell="markov-64k.host-1m", seconds="2"):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 4242), "--seconds", seconds, "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=900)


def test_a_short_run_is_correct(card):
    r = _run(ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    assert r.stderr.strip().splitlines()[-1].startswith("check ")


def test_without_the_program_no_result(card, tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
