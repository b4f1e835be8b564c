"""BASELINE config 5's entry point and F7 on the CPU, held to the JAX
package at small sizes.

`mhc_tpu_torch.bench.multigb` streams a file through the chained segments
of the file functions (on the card in chip_smoke.py's `multigb` phase, at
2.25 GiB); here it runs at 64 KiB segments and must write the reference's
`compress_file` bytes. F7: the histograms are int64, and a cell past
2**31 builds the host builder's lengths and tables.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from mhc_tpu import api as ref_api
from mhc_tpu.ops import histogram as ref_histogram
from mhc_tpu.ops import huffman as ref_huffman
from mhc_tpu_torch.bench import multigb
from mhc_tpu_torch.models.entropy import get_model
from mhc_tpu_torch.ops import huffman
from mhc_tpu_torch.ops.kernels import huffman_cuda
from mhc_tpu_torch.utils import corpus

CPU = torch.device("cpu")
SEG = 64 << 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_KEYS = ("bytes", "segment_mb", "n_segments", "ratio", "encode_s",
                  "decode_s", "encode_MBps", "decode_MBps", "roundtrip_ok",
                  "peak_rss_GB")


def test_multigb_run_writes_the_reference_chain(tmp_path):
    """3 segments of 64 KiB and a tail: the chain is the bytes of the
    reference's compress_file, the round trip exact, the reference's keys
    there."""
    src = tmp_path / "in.bin"
    src.write_bytes(corpus.make_corpus(3 * SEG + 12_345, seed=17))
    dst = tmp_path / "out.mhc"
    res = multigb.run(str(src), SEG, "cpu", dst=str(dst))
    ref = tmp_path / "ref.mhc"
    stats = ref_api.compress_file(str(src), str(ref), segment_size=SEG)
    assert dst.read_bytes() == ref.read_bytes()
    assert all(k in res for k in REFERENCE_KEYS)
    assert res["roundtrip_ok"] is True
    assert res["n_segments"] == stats["n_segments"] == 4
    assert res["bytes"] == 3 * SEG + 12_345
    assert res["segment_mb"] == SEG / (1 << 20)
    assert res["ratio"] == stats["ratio"]
    assert res["compressed_bytes"] == len(ref.read_bytes())
    assert res["platform"] == "cpu"
    assert res["peak_rss_GB"] >= res["rss_base_GB"] > 0
    assert res["peak_rss_over_base_GB"] == pytest.approx(
        res["peak_rss_GB"] - res["rss_base_GB"])
    assert res["peak_device_bytes"] == {"compress": None,
                                        "decompress": None}
    assert not os.path.exists(str(dst) + ".out")


def test_multigb_exits_1_without_a_card(tmp_path):
    """Without a card and without --device cpu: exit 1, and the default
    input is never written."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path)}
    r = subprocess.run([sys.executable, "-m", "mhc_tpu_torch.bench.multigb",
                        "0.001", "1"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert "multigb:" in r.stderr and not r.stdout
    assert os.listdir(tmp_path) == []


def test_multigb_default_input_is_the_reference_file(tmp_path, monkeypatch):
    """The default input is bench/multigb.py's: make_corpus pieces of
    seed 100 + k (one piece at this size), under the reference's name."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    n_gb = 0.0001
    path = multigb.default_input(n_gb)
    assert os.path.basename(path) == f"mhc_multigb_{n_gb}g.bin"
    with open(path, "rb") as f:
        assert f.read() == bench.make_corpus(int(n_gb * (1 << 30)),
                                             seed=100)


@pytest.mark.parametrize("n", [0, 1, 999, 1000, 2000, 2 * 1000 + 123])
def test_tiled_corpus_equals_the_repeated_corpus(n):
    tile = bench.make_corpus(1000)
    assert corpus.tiled_corpus(n, tile_bytes=1000) == (tile * 3)[:n]
    assert corpus.tiled_corpus(n, 1000, tile=tile) == (tile * 3)[:n]


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_f7_histogram_is_int64_and_equals_the_reference(mode):
    model = get_model(mode)
    data = np.frombuffer(corpus.make_corpus(5 * 4096 + 77), np.uint8)
    units = np.zeros((6, 4096), np.uint8)
    units.reshape(-1)[: data.size] = data
    nv = np.array([4096] * 5 + [77], np.int32)
    got = model.histogram(torch.from_numpy(units), torch.from_numpy(nv))
    ref_fn = (ref_histogram.histogram_markov if model.markov
              else ref_histogram.histogram_order0)
    ref = np.asarray(ref_fn(jnp.asarray(units), jnp.asarray(nv),
                            method="matmul"))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_f7_tables_for_a_cell_of_3e9_equal_the_host_build(mode):
    """Counts with one cell of 3 * 10**9 (past int32; 2.25 GiB of zeros
    puts 2,415,931,449 there): `tables_for` on the CPU and the fused
    build's plain version (what the card's kernel is held to) give the
    reference host builder's lengths (`code_lengths_np`, int64 rescale)
    and the tables of those lengths."""
    model = get_model(mode)
    rng = np.random.default_rng(7)
    shape = (256, 256) if model.markov else (256,)
    counts = rng.integers(0, 1000, shape).astype(np.int64)
    counts[rng.random(shape) < 0.5] = 0
    counts.reshape(-1)[0] = 3 * 10 ** 9
    rows = counts.reshape(-1, 256)
    want = np.stack([ref_huffman.code_lengths_np(r) for r in rows])
    np.testing.assert_array_equal(
        want, np.stack([huffman.code_lengths_np(r) for r in rows]))
    lengths, tables = model.tables_for(torch.from_numpy(counts), CPU)
    np.testing.assert_array_equal(np.asarray(lengths).reshape(-1, 256),
                                  want)
    plain_lengths, plain_tables = huffman_cuda.code_tables_plain(
        torch.from_numpy(rows.copy()), 256)
    np.testing.assert_array_equal(plain_lengths.numpy(), want)
    expect = model.tables_from_lengths(want.reshape(shape), CPU)
    for k, t in expect.items():
        assert torch.equal(tables[k], t), k
        assert torch.equal(plain_tables[k], t), k
