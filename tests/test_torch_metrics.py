"""The port's observability (mhc_tpu_torch.utils.metrics) and its MHC_TRACE
phase trace, against the JAX package's: the counterpart of
tests/test_metrics.py, plus the trace lines of api.compress / decompress
on the CPU, whose phases are a subset of the reference's for the same
call and which leave the bytes unchanged."""

import json
import os

import pytest
import torch

from mhc_tpu import api as jax_api
from mhc_tpu.utils import metrics as jax_metrics
from mhc_tpu_torch import api
from mhc_tpu_torch.utils import metrics
from tests.corpus import mixed_binary


@pytest.mark.parametrize("sync", ["tensor", "list", "device"])
def test_trace_phases(sync):
    tr = metrics.Trace()
    x = torch.ones((128, 128))
    syncs = {"tensor": lambda y: y, "list": lambda y: [y, x],
             "device": lambda y: torch.device("cpu")}[sync]
    with tr.phase("matmul", nbytes=128 * 128 * 4, sync=syncs(x)):
        y = x @ x
    with tr.phase("matmul", nbytes=128 * 128 * 4, sync=syncs(y)):
        y = y @ x
    rep = tr.report()
    assert rep["matmul"]["calls"] == 2
    assert rep["matmul"]["bytes"] == 2 * 128 * 128 * 4
    assert rep["matmul"]["seconds"] > 0
    assert set(rep["matmul"]) == {"seconds", "bytes", "GBps", "calls"}
    assert json.loads(tr.dumps()) == rep


@pytest.mark.parametrize("args", [
    (1 << 20, 8, 8.0, 1.25), (1 << 30, 4, 2.0, 0.5), (12345, 1, 1.0, 1.0),
    (1 << 20, 2, 3.0, 0.0), (0, 4, 0.0, 1.0), (100 << 20, 3, 0.9, 0.4),
])
def test_scaling_report_is_the_reference(args):
    assert metrics.scaling_report(*args) == jax_metrics.scaling_report(*args)


def test_torch_profile_writes_a_trace(tmp_path):
    with metrics.torch_profile(tmp_path, "cpu"):
        y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(y.sum()) == 64 ** 3
    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def _trace_line(err: str, what: str) -> dict:
    lines = [ln for ln in err.splitlines()
             if ln.startswith(f"[mhc-trace {what}] ")]
    assert len(lines) == 1, err
    return json.loads(lines[0].split("] ", 1)[1])


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_mhc_trace_lines(monkeypatch, capsys, mode):
    data = mixed_binary(70_001, seed=5)
    monkeypatch.delenv("MHC_TRACE", raising=False)
    plain = api.compress(data, mode=mode, device="cpu")
    assert api.decompress(plain, device="cpu") == data
    assert "mhc-trace" not in capsys.readouterr().err

    monkeypatch.setenv("MHC_TRACE", "1")
    # three chunks, so that the per-chunk phases are called more than once
    monkeypatch.setattr(api, "CHUNK_BYTES", 32 << 10)
    blob = api.compress(data, mode=mode, device="cpu")
    enc = _trace_line(capsys.readouterr().err, "compress")
    assert api.decompress(blob, device="cpu") == data
    dec = _trace_line(capsys.readouterr().err, "decompress")
    assert blob == plain

    ref = jax_api.compress(data, mode=mode)
    ref_enc = _trace_line(capsys.readouterr().err, "compress")
    assert jax_api.decompress(ref) == data
    ref_dec = _trace_line(capsys.readouterr().err, "decompress")
    assert ref == blob

    assert set(enc) <= set(ref_enc) and set(dec) <= set(ref_dec)
    assert set(enc) == {"blockify", "h2d", "tables", "crc32", "pack", "d2h",
                        "container"}
    assert set(dec) == {"h2d", "decode", "d2h", "crc32"}
    for name in ("blockify", "tables", "crc32", "pack"):
        assert enc[name]["bytes"] == len(data), name
    # 9 units of 8 KB, 4 a chunk (Markov); 5 of 16 KB, 2 a chunk (order-0)
    assert enc["pack"]["calls"] == enc["blockify"]["calls"] == 3
    assert dec["decode"]["calls"] == dec["h2d"]["calls"] == 3
    assert dec["decode"]["bytes"] == dec["crc32"]["bytes"] == len(data)
    assert all(p["seconds"] >= 0 for p in {**enc, **dec}.values())


def test_mhc_trace_unset_prints_nothing(capsys):
    assert not os.environ.get("MHC_TRACE")
    blob = api.compress(b"abc" * 1000, device="cpu")
    assert api.decompress(blob, device="cpu") == b"abc" * 1000
    assert capsys.readouterr().err == ""
