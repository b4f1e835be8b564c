"""BASELINE config 5's one-card share (`benchmark/configs/markov-multigb.json`)
on the CPU, and the engine's held-memory reading.

(a) The port's engine against the benchmark's plain reference
(`benchmark/reference/codec.py`) at the configuration's parameters, on
the share cut to a thousandth of its scale with its tail kept: 2^21 +
2^18 + 12,345 B, so that the last 64 KB block holds 12,345 B and the
last 8 KB unit 4,153 B, as in the 2,415,931,449 B share. (b) The
reference's code lengths and the port's table builds on a (256, 256)
int64 histogram with cells past 2^31, the counts only the full share
reaches. (c) The sharded pipeline's steps on staged shares
(`pipeline.encode_staged`, `gather_container`, `gather_bytes`): in a
world of one they are the engine's, and over two gloo ranks, each with
its share staged, the gathered container is the reference's for the
whole and the gathered bytes are the whole; a share that ends off a
decode unit before the last is refused on every rank.
"""

import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import codec as reference
from mhc_tpu_torch import engine
from mhc_tpu_torch.models.entropy import get_model
from mhc_tpu_torch.ops.kernels import huffman_cuda
from mhc_tpu_torch.parallel import mesh as meshmod, pipeline
from tests.torch_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmark", "configs",
                       "markov-multigb.json")) as _f:
    CONFIG = json.load(_f)
SHARE = CONFIG["deployment"]["share_bytes"]
# the share at a thousandth of its scale: 2^31 + 2^28 -> 2^21 + 2^18,
# the same 12,345 B past them
SCALED = 2 ** 21 + 2 ** 18 + 12_345


def test_the_scaled_share_keeps_the_shares_tail():
    bs, du = CONFIG["block_size"], CONFIG["decode_unit"]
    assert SHARE == 2 ** 31 + 2 ** 28 + 12_345
    assert CONFIG["deployment"]["world"] * SHARE == \
        CONFIG["deployment"]["corpus_bytes"]
    for n, blocks, units in ((SHARE, 36_865, 294_914), (SCALED, 37, 290)):
        assert -(-n // bs) == blocks and -(-n // du) == units
        assert n % bs == 12_345 and n % du == 4_153


def _stage(data):
    c = CONFIG
    return engine.stage(data, mode=c["mode"], block_size=c["block_size"],
                        decode_unit=c["decode_unit"], device="cpu")


@pytest.mark.parametrize("seed", [21, 2 ** 31 + 21, 2 ** 40 + 21])
def test_the_share_through_the_engine_equals_the_reference(seed):
    c = CONFIG
    data = inputs.corpus(SCALED, seed)
    st = _stage(data)
    assert st.n_units == 290
    enc = engine.encode(st)
    want = reference.encode(data, c["mode"], c["block_size"],
                            c["decode_unit"], crc=c["crc"])
    got = engine.assemble_container(enc, zlib.crc32(data) & 0xFFFFFFFF)
    assert got == want
    rows = engine.decode(enc)
    assert engine.fetch_bytes(enc, rows) == data.tobytes()


def _counts_past_2_31(seed: int) -> np.ndarray:
    """A (256, 256) int64 histogram: sparse rows of small counts, cells
    between 2^31 and 2^34 among them, and a row of such cells alone."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 1 << 20, (256, 256), dtype=np.int64)
    counts[rng.random((256, 256)) < 0.5] = 0
    big = rng.random((256, 256)) < 0.01
    counts[big] = rng.integers(1 << 31, 1 << 34, int(big.sum()))
    counts[7] = rng.integers(1 << 31, 1 << 34, 256)
    counts[9] = 0
    return counts


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 5])
def test_table_builds_equal_the_reference_past_2_31(seed):
    counts = _counts_past_2_31(seed)
    assert counts.max() >= 2 ** 31 and (counts.sum(axis=1) >= 2 ** 32).any()
    want = reference.code_lengths(counts)
    codes = reference.canonical_codes(want)
    t = torch.from_numpy(counts)
    host_lengths, host_tables = get_model("markov").tables_for(t, "cpu")
    card_lengths, card_tables = huffman_cuda.code_tables_plain(t, 256)
    for lengths, tables in ((host_lengths, host_tables),
                            (card_lengths, card_tables)):
        np.testing.assert_array_equal(lengths.numpy(), want)
        present = want > 0
        np.testing.assert_array_equal(tables["codes"].numpy()[present],
                                      codes[present])


def _crc(data) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _want(data) -> bytes:
    c = CONFIG
    return reference.encode(data, c["mode"], c["block_size"],
                            c["decode_unit"], crc=c["crc"])


def test_staged_steps_in_a_world_of_one_are_the_engines():
    data = inputs.corpus(40 * 8192 + 4153, 31)
    st = _stage(data)
    enc = pipeline.encode_staged(st)
    plain = engine.encode(st)
    assert torch.equal(enc.payload, plain.payload)
    np.testing.assert_array_equal(enc.lengths, plain.lengths)
    np.testing.assert_array_equal(enc.bit_lens, plain.bit_lens)
    assert pipeline.gather_container(enc, _crc(data)) == _want(data)
    assert pipeline.gather_bytes(enc, engine.decode(enc)) == data.tobytes()


def test_encode_staged_refuses_a_rank_on_another_device():
    st = _stage(inputs.corpus(8192, 32))
    mesh = meshmod.Mesh(None, 0, 1, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="staged on cpu"):
        pipeline.encode_staged(st, mesh)


_WORKER = r'''
import json, sys
import torch.distributed as dist
from mhc_tpu_torch import engine
from mhc_tpu_torch.parallel import mesh as meshmod, pipeline

rank, tmp, cut, crc = (int(sys.argv[1]), sys.argv[2], int(sys.argv[3]),
                       int(sys.argv[4]))
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 2),
                        rank=rank, world_size=2)
mesh = meshmod.make_mesh("cpu")
cfg = json.load(open(f"{tmp}/cfg.json"))
data = open(f"{tmp}/data.bin", "rb").read()


def share(at):
    return engine.stage(data[:at] if rank == 0 else data[at:],
                        mode=cfg["mode"], block_size=cfg["block_size"],
                        decode_unit=cfg["decode_unit"], device="cpu")


enc = pipeline.encode_staged(share(cut), mesh)
with open(f"{tmp}/rank{rank}.mhc", "wb") as f:
    f.write(pipeline.gather_container(enc, crc, mesh))
with open(f"{tmp}/rank{rank}.out", "wb") as f:
    f.write(pipeline.gather_bytes(enc, engine.decode(enc), mesh))
try:
    pipeline.gather_container(pipeline.encode_staged(share(cut + 1), mesh),
                              crc, mesh)
    refused = ""
except ValueError as e:
    refused = str(e)
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump({"refused": refused}, f)
dist.destroy_process_group()
'''


def test_staged_shares_over_two_ranks_gather_to_the_whole(tmp_path):
    """Rank 0 holds 23 units (the cut inside a 64 KB block), rank 1 the
    rest with the 4,153 B tail."""
    data = inputs.corpus(40 * 8192 + 4153, 33)
    cut = 23 * CONFIG["decode_unit"]
    (tmp_path / "data.bin").write_bytes(data.tobytes())
    (tmp_path / "cfg.json").write_text(json.dumps(CONFIG))
    (tmp_path / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(r),
         str(tmp_path), str(cut), str(_crc(data))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    want = _want(data)
    for r in range(2):
        assert (tmp_path / f"rank{r}.mhc").read_bytes() == want
        assert (tmp_path / f"rank{r}.out").read_bytes() == data.tobytes()
        refused = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert "must end on a decode unit" in refused["refused"]
