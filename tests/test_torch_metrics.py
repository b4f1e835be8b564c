"""The port's observability (mhc_tpu_torch.utils.metrics) and its MHC_TRACE
phase trace, against the JAX package's: the counterpart of
tests/test_metrics.py, plus the trace lines of api.compress / decompress
on the CPU, whose phases are a subset of the reference's for the same
call and which leave the bytes unchanged."""

import json
import os
import sys
import threading

import pytest
import torch

from mhc_tpu import api as jax_api
from mhc_tpu.utils import metrics as jax_metrics
from mhc_tpu_torch import api
from mhc_tpu_torch.utils import metrics
from tests.corpus import mixed_binary


def _nested_call(nbytes: int):
    """One top-level api span with two phases, the second holding an
    engine span and a launch inside it."""
    with metrics.span("mhc.api.compress", nbytes):
        with metrics.span("mhc.api.blockify", nbytes):
            pass
        with metrics.span("mhc.api.pack", nbytes):
            with metrics.span("mhc.engine.encode", nbytes):
                with metrics.span("mhc.launch.pack_units"):
                    torch.ones((64, 64)) @ torch.ones((64, 64))


def _check_spans(tr, calls: int, nbytes: int):
    names = ["mhc.api.compress", "mhc.api.blockify", "mhc.api.pack",
             "mhc.engine.encode", "mhc.launch.pack_units"]
    assert [s.name for s in tr.spans] == names * calls
    for c in range(calls):
        i = 5 * c
        one = tr.spans[i: i + 5]
        assert [s.parent for s in one] == [None, i, i, i + 2, i + 3]
        assert {s.call for s in one} == {c}
        for s in one:
            assert s.t1_ns >= s.t0_ns
            if s.parent is not None:
                p = tr.spans[s.parent]
                assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    rep = tr.report()
    # the api's phases alone: the top-level span, the engine's and the
    # launch's are no phase
    assert set(rep) == {"blockify", "pack"}
    assert rep["pack"]["calls"] == calls
    assert rep["pack"]["bytes"] == calls * nbytes
    assert rep["pack"]["seconds"] > 0
    assert set(rep["pack"]) == {"seconds", "bytes", "GBps", "calls"}
    assert json.loads(tr.dumps()) == rep
    assert tr.report(omit=("pack",)).keys() == {"blockify"}


@pytest.mark.parametrize("case", ["nesting", "call_ids", "threads"])
def test_trace_phases(case):
    """The span recorder: parents and nesting; one call id for every
    span under a top-level span, a new one for the next; and two threads
    tracing at once, each trace holding its own spans alone."""
    if case == "nesting":
        with metrics.tracing() as tr:
            _nested_call(4096)
        _check_spans(tr, 1, 4096)
        # no trace active and no profiler: nothing is recorded
        _nested_call(4096)
        assert len(tr.spans) == 5
    elif case == "call_ids":
        with metrics.tracing() as tr:
            for _ in range(3):
                _nested_call(100)
        _check_spans(tr, 3, 100)
    else:
        barrier = threading.Barrier(2, timeout=30)
        traces, errors = {}, []

        def work(name):
            try:
                with metrics.tracing() as tr:
                    for _ in range(4):
                        barrier.wait()
                        _nested_call(len(name))
                        barrier.wait()
                traces[name] = tr
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        # four calls on each side, entered and left in step
        threads = [threading.Thread(target=work, args=(name,))
                   for name in ("a", "bb")]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not errors and not any(t.is_alive() for t in threads)
        _check_spans(traces["a"], 4, 1)
        _check_spans(traces["bb"], 4, 2)


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
