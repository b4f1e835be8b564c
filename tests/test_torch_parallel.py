"""The port's sharded pipeline over gloo ranks on the CPU, against the
JAX package: the counterpart of tests/test_parallel.py (psum histogram,
replicated table build, sharded encode and decode, ordered gather) and
tests/test_multihost.py (separate processes, one world).

Two ranks run every case in one spawn per module: subprocesses meeting
through a FileStore in a temporary directory, so that test workers never
collide on a port. Each rank writes what it got; the tests compare:
every rank's `compress_sharded` container equals `mhc_tpu.api.compress`,
and the sharded decode of it and of the JAX container gives the input
back, as do the single-device decoders of both packages. The sharded
file functions write from local rank 0 only.
"""

import json
import os
import subprocess
import sys

import pytest

from mhc_tpu import api as jax_api
from mhc_tpu_torch import api, cli
from tests.corpus import english_like, mixed_binary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# "markov" and "odd_unit_count" are 25 units of 4 KB each (25 is odd:
# the second rank's share ends in a padding unit), so that the JAX
# package compiles their shape once
CASES = {
    "markov": (mixed_binary(100_000, 11), dict(mode="markov",
                                               block_size=4096)),
    "order0_ragged": (english_like(3 * 16384 + 37, 3),
                      dict(mode="huffman")),
    "decode_unit_2048": (english_like(48 * 1024 + 5, 9),
                         dict(mode="markov", block_size=16384,
                              decode_unit=2048)),
    "odd_unit_count": (english_like(25 * 4096 - 999, 6),
                       dict(mode="markov", block_size=4096)),
    "empty": (b"", {}),
    "one_byte": (b"x", {}),
    "xy3": (b"xy" * 3, {}),
}
FILE_CASE = "order0_ragged"

_WORKER = r'''
import json, os, sys
import torch.distributed as dist
from mhc_tpu_torch import api
from mhc_tpu_torch.parallel import mesh as meshmod, pipeline

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", world),
                        rank=rank, world_size=world)
mesh = meshmod.make_mesh("cpu")
cases = json.load(open(f"{tmp}/cases.json"))
out = {}
for name, kw in cases.items():
    data = open(f"{tmp}/{name}.bin", "rb").read()
    ref = open(f"{tmp}/{name}.ref", "rb").read()
    blob = pipeline.compress_sharded(data, mesh, **kw)
    open(f"{tmp}/{name}.rank{rank}.mhc", "wb").write(blob)
    out[name] = {"own": pipeline.decompress_sharded(blob, mesh) == data,
                 "ref": pipeline.decompress_sharded(ref, mesh) == data}
name = sys.argv[4]
os.environ["LOCAL_RANK"] = str(rank)
api.compress_file(f"{tmp}/{name}.bin", f"{tmp}/file.rank{rank}.mhc",
                  segment_size=20000, sharded=True, mesh=mesh,
                  **cases[name])
api.decompress_file(f"{tmp}/file.rank0.mhc", f"{tmp}/back.rank{rank}.bin",
                    sharded=True, mesh=mesh)
json.dump(out, open(f"{tmp}/result.rank{rank}.json", "w"))
dist.destroy_process_group()
'''


def _spawn(tmp, world: int, cases: dict, file_case: str) -> None:
    """`world` gloo ranks over `cases` (name -> (data, kwargs)), each
    case's JAX container beside its input in `tmp`; the file functions
    on `file_case`."""
    for name, (data, kw) in cases.items():
        (tmp / f"{name}.bin").write_bytes(data)
        (tmp / f"{name}.ref").write_bytes(jax_api.compress(data, **kw))
    (tmp / "cases.json").write_text(
        json.dumps({n: kw for n, (_, kw) in cases.items()}))
    (tmp / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(world),
         str(tmp), file_case], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded2")
    _spawn(tmp, 2, CASES, FILE_CASE)
    return tmp


def _result(tmp, rank: int) -> dict:
    return json.loads((tmp / f"result.rank{rank}.json").read_text())


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_container_equals_jax_compress(two_ranks, case):
    ref = (two_ranks / f"{case}.ref").read_bytes()
    for rank in (0, 1):
        assert (two_ranks / f"{case}.rank{rank}.mhc").read_bytes() == ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_round_trip_and_cross_decode(two_ranks, case):
    """Both ranks decode their own container and the JAX one; the
    single-device decoder decodes the sharded one (the JAX package's, as
    the bytes equal its own container)."""
    data = CASES[case][0]
    for rank in (0, 1):
        assert _result(two_ranks, rank)[case] == {"own": True, "ref": True}
    blob = (two_ranks / f"{case}.rank0.mhc").read_bytes()
    assert api.decompress(blob, device="cpu") == data


def test_sharded_files_written_by_local_rank_0(two_ranks, tmp_path):
    """Segments of 20,000 bytes: the single-device file's chain."""
    data, kw = CASES[FILE_CASE]
    (tmp_path / "in.bin").write_bytes(data)
    api.compress_file(str(tmp_path / "in.bin"), str(tmp_path / "ref"),
                      segment_size=20000, device="cpu", **kw)
    assert ((two_ranks / "file.rank0.mhc").read_bytes()
            == (tmp_path / "ref").read_bytes())
    assert (two_ranks / "back.rank0.bin").read_bytes() == data
    assert not (two_ranks / "file.rank1.mhc").exists()
    assert not (two_ranks / "back.rank1.bin").exists()


def test_cli_sharded_is_a_world_of_one(tmp_path, capsys):
    data, kw = CASES["markov"]
    src, mhc, back = (str(tmp_path / n) for n in ("in", "in.mhc", "back"))
    with open(src, "wb") as f:
        f.write(data)
    assert cli.main(["encode", "--device", "cpu", "--sharded",
                     "--block-size", "4K", src, mhc]) == 0
    with open(mhc, "rb") as f:
        assert f.read() == jax_api.compress(data, **kw)
    assert cli.main(["decode", "--device", "cpu", "--sharded", mhc,
                     back]) == 0
    with open(back, "rb") as f:
        assert f.read() == data
    capsys.readouterr()


@pytest.mark.slow
def test_four_ranks(tmp_path):
    cases = {k: CASES[k] for k in ("markov", "odd_unit_count", "one_byte")}
    _spawn(tmp_path, 4, cases, "markov")
    for case in cases:
        ref = (tmp_path / f"{case}.ref").read_bytes()
        for rank in range(4):
            assert (tmp_path / f"{case}.rank{rank}.mhc").read_bytes() == ref
            assert _result(tmp_path, rank)[case] == {"own": True,
                                                     "ref": True}


@pytest.mark.slow
def test_cli_distributed_under_torchrun(tmp_path):
    """`--distributed` as torchrun launches it: two gloo ranks, env://."""
    data, kw = CASES["markov"]
    src, mhc, back = (str(tmp_path / n) for n in ("in", "in.mhc", "back"))
    with open(src, "wb") as f:
        f.write(data)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for args in (["encode", "--block-size", "4K", src, mhc],
                 ["decode", mhc, back]):
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "mhc_tpu_torch.cli", args[0],
             "--distributed", "--device", "cpu", *args[1:]],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=600)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    with open(mhc, "rb") as f:
        assert f.read() == jax_api.compress(data, **kw)
    with open(back, "rb") as f:
        assert f.read() == data
