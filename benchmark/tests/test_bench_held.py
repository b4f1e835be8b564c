"""The cell `markov-multigb.resident-2g`: it resolves through the harness
with its configuration, its mix and its metrics; the entry
`resident_held` runs the share through the sharded pipeline's staged
steps in a world of one rank, judges the ordered gather's container and
bytes, and reads each call's held memory from the allocator's events
under the profiler, never resetting the peak statistics; each reader
returns None with nothing to read. Marked `cuda`: the entry at a reduced
size on the card, its peaks against the allocator's own."""

import dataclasses
import json
import os
import time

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT
from benchmark import harness
from mhc_tpu_torch.parallel import pipeline
from mhc_tpu_torch.utils import metrics

CELL = "markov-multigb.resident-2g"
METRICS = ["engine_held_per_byte.encode", "engine_held_per_byte.decode"]


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def _entry_module():
    return harness.load_entry("resident_held")


def test_the_cell_resolves_with_its_config_mix_and_metrics():
    cell = harness.load_cell(CELL)
    cfg, base = cell.config, _json("benchmark", "configs", "markov-64k.json")
    assert cfg["name"] == "markov-multigb"
    # markov-64k's codec and guarantees, no width or shape changed
    for key in ("mode", "block_size", "decode_unit", "crc", "verify",
                "guarantees"):
        assert cfg[key] == base[key], key
    assert cfg["reduced"] == ["world"] and cfg["world"] == 1
    assert set(cfg["cuts"]) == set(cfg["reduced"])
    assert "encode_staged" in cfg["cuts"]["world"]
    d = cfg["deployment"]
    assert d["world"] == d["hosts"] * d["cards_per_host"] == 16
    assert d["corpus_bytes"] == d["world"] * d["share_bytes"]
    t = cell.traffic
    assert t["object_bytes"] == d["share_bytes"] == 2 ** 31 + 2 ** 28 + 12_345
    assert (t["entry"], t["pool"], t["sample"], t["control"]) == (
        "resident_held", 1, 1, "no_literals")
    assert t["kinds"] == {k: 0.25 for k in ("text", "counters", "repeat",
                                            "noise")}
    assert (cell.chips, t["warmup_round_trips"], t["trace_round_trips"]) == (
        1, 2, 4)
    per_layer = [m["name"] for m in cell.per_layer]
    assert set(METRICS) <= set(per_layer)
    # the engine's host plan and the launches are read here too
    for name in ("device_idle_share.encode", "engine_self_ms.encode",
                 "engine_self_ms.decode", "launch_host_ms.encode",
                 "launch_host_ms.decode"):
        assert name in per_layer, name
    assert not {"api_self_ms.compress", "api_host_ms.compress"} & set(
        per_layer)
    for m in cell.per_layer:
        if m["name"] in METRICS:
            assert (m["unit"], m["layer"], m["moves"], m["source"],
                    m["workloads"]) == ("B/B", "engine", "peak_device_GB",
                                        "device_trace", [CELL])
    assert [m["name"] for m in cell.end_to_end] == [
        "encode_GBps", "decode_GBps", "peak_device_GB", "setup_s"]
    # the metrics are this cell's alone
    other = harness.load_cell("markov-64k.resident-100m")
    assert not set(METRICS) & {m["name"] for m in other.per_layer}


def small(n=65536 + 8193):
    cell = harness.load_cell(CELL)
    return dataclasses.replace(cell, traffic={
        **cell.traffic, "object_bytes": n, "warmup_round_trips": 1,
        "trace_round_trips": 1})


def _entry(device="cpu", n=65536 + 8193):
    from benchmark import inputs
    cell = small(n)
    objects = inputs.pool(1, n, 2 ** 31 + 9)
    return _entry_module().Entry(cell.config, cell.traffic, objects, device)


def test_the_entry_is_the_resident_entry_on_the_pipelines_steps():
    held = _entry_module().Entry
    resident = harness.load_entry("resident").Entry
    assert [c.__name__ for c in held.__mro__[:3]] == ["Entry", "Entry",
                                                      "object"]
    # loaded from resident.py, not copied
    assert held.__mro__[1].__module__ == resident.__module__
    for name in ("decode", "keep", "in_bytes", "payload_bytes"):
        assert name not in vars(held)
        assert getattr(held, name).__code__.co_filename.endswith(
            os.path.join("entries", "resident.py")), name
    for name in ("encode", "judge", "host_phases", "close"):
        assert name in vars(held), name
    assert "host_phases" not in vars(resident)


def test_a_world_of_one_is_made_and_ended_by_the_entry(monkeypatch):
    assert not dist.is_initialized()
    calls = []
    real = pipeline.encode_staged
    monkeypatch.setattr(pipeline, "encode_staged",
                        lambda st, mesh: calls.append(mesh) or real(st, mesh))
    entry = _entry()
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert entry.mesh.group is not None and entry.mesh.world_size == 1
    enc = entry.encode(0)
    k, blob, data = entry.judge(entry.keep(0, enc, entry.decode(0, enc)))
    assert calls == [entry.mesh]
    assert data == entry_object(entry)
    store = entry.store_dir
    entry.close()
    assert not dist.is_initialized() and not os.path.exists(store)


def entry_object(entry) -> bytes:
    from benchmark import inputs
    return inputs.pool(1, entry.in_bytes(0), 2 ** 31 + 9)[0].tobytes()


def test_the_entry_raises_before_staging_without_encode_staged(
        monkeypatch):
    monkeypatch.delattr(pipeline, "encode_staged")
    staged = []
    resident = harness.load_entry("resident")
    monkeypatch.setattr(resident.engine, "stage",
                        lambda *a, **k: staged.append(a))
    with pytest.raises(AttributeError):
        _entry()
    assert staged == [] and not dist.is_initialized()


def test_host_phases_gives_nothing_off_a_card():
    entry = _entry()
    try:
        assert entry.host_phases(2) == []
    finally:
        entry.close()


def test_held_reads_the_peak_and_the_span_innermost_at_it():
    held = _entry_module().held
    ranges = [(0, 100, "mhc.engine.encode"), (10, 40, "mhc.engine.pack"),
              (50, 90, "mhc.engine.compact"), (60, 70, "mhc.launch.k")]
    mem = [(12, 500), (30, -200), (55, 400), (65, 300), (80, -700),
           (95, 50)]
    peak, at, steps = held(mem, ranges, 1000)
    # 1000 +500 -200 +400 +300 = 2000 inside the launch
    assert (peak, at) == (2000, "mhc.launch.k")
    assert steps == [["mhc.engine.encode", 2000], ["mhc.engine.pack", 1500],
                     ["mhc.engine.compact", 2000], ["mhc.launch.k", 2000]]
    # nothing allocated: the entry's bytes, no span
    assert held([], ranges, 1000) == (1000, None, [])
    # a peak outside every span
    assert held([(200, 5)], ranges, 0) == (5, None, [])


def test_memory_events_of_a_real_profile_on_the_cpu():
    mod = _entry_module()
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        with metrics.span("mhc.engine.encode"):
            a = torch.zeros(1 << 18)
            with metrics.span("mhc.engine.pack"):
                b = torch.zeros(1 << 20)
                del b
            del a
    mem, ranges = mod.memory_events(prof.profiler.kineto_results.events(),
                                    torch.device("cpu"))
    assert [r[2] for r in sorted(ranges)] == ["mhc.engine.encode",
                                               "mhc.engine.pack"]
    peak, at, steps = mod.held(mem, ranges, 0)
    assert (peak, at) == (4 * ((1 << 18) + (1 << 20)), "mhc.engine.pack")
    assert dict(steps)["mhc.engine.encode"] == peak
    # the card's events alone on a card
    assert mod.memory_events(prof.profiler.kineto_results.events(),
                             torch.device("cuda", 0))[0] == []


def test_the_readers_average_the_calls_and_name_the_step(capsys):
    calls = [{"role": "encode", "bytes": 100, "entry_bytes": 1000,
              "peak_bytes": 1250, "peak_step": "mhc.engine.compact",
              "steps": [["mhc.engine.compact", 1250]]},
             {"role": "decode", "bytes": 100, "entry_bytes": 1100,
              "peak_bytes": 1400, "peak_step": "mhc.engine.rows",
              "steps": [["mhc.engine.rows", 1400]]},
             {"role": "encode", "bytes": 100, "entry_bytes": 1000,
              "peak_bytes": 1230, "peak_step": "mhc.engine.pack",
              "steps": [["mhc.engine.pack", 1230]]}]
    run = harness.Run(cell=small(), trace=harness.tracing.TraceData(
        device=[], spans={}, host_phases=calls))
    assert harness.load_metric(METRICS[0]).read(run) == pytest.approx(2.4)
    assert harness.load_metric(METRICS[1]).read(run) == pytest.approx(3.0)
    err = capsys.readouterr().err
    assert "the step that held the most: mhc.engine.compact 1250 B" in err
    assert "the step that held the most: mhc.engine.rows 1400 B" in err


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_returns_none_with_nothing_to_read(name):
    read = harness.load_metric(name).read
    cell = small()
    assert read(harness.Run(cell=cell)) is None
    empty = harness.tracing.TraceData(device=[], spans={})
    assert read(harness.Run(cell=cell, trace=empty)) is None
    # a host cell's MHC_TRACE reports are no readings
    reports = harness.tracing.TraceData(
        device=[], spans={},
        host_phases=[{"crc32": {"seconds": 0.1, "bytes": 1, "calls": 1}}])
    assert read(harness.Run(cell=cell, trace=reports)) is None


def test_a_traced_cpu_run_reports_no_held_metric():
    r = harness.run(small(600), 2 ** 31 + 3, 0.05, True, "cpu",
                    time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert not set(METRICS) & set(r["metrics"])
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_the_entry_on_the_card_reads_the_allocators_own_peak(card):
    """One round trip at a reduced size: the pass leaves the allocator's
    peak statistics alone, and each call's peak from the events equals
    the allocator's own peak over that call."""
    entry = _entry(card, 64 * 8192 + 4153)
    try:
        enc = entry.encode(0)
        entry.decode(0, enc)
        del enc
        torch.cuda.synchronize(card)
        before = torch.cuda.max_memory_allocated(card)
        got = entry.host_phases(1)
        assert torch.cuda.max_memory_allocated(card) >= before
        assert [r["role"] for r in got] == ["encode", "decode"]
        for r in got:
            assert r["peak_bytes"] > r["entry_bytes"] > 0, r
            assert r["peak_step"].startswith("mhc."), r
            assert r["peak_bytes"] <= torch.cuda.max_memory_allocated(card)
        # the allocator's own peak over a call (reset here, in a test)
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
        enc, r = entry._held_call("encode", 0, lambda: entry.encode(0))
        assert r["peak_bytes"] == torch.cuda.max_memory_allocated(card)
        torch.cuda.reset_peak_memory_stats(card)
        _, r = entry._held_call("decode", 0, lambda: entry.decode(0, enc))
        assert r["peak_bytes"] == torch.cuda.max_memory_allocated(card)
    finally:
        entry.close()


@pytest.mark.cuda
def test_the_cell_on_the_card_for_one_round_trip(card, capsys):
    cell = small(64 * 8192 + 4153)
    r = harness.run(cell, 2 ** 31 + 4243, 0.05, True, card,
                    time.perf_counter())
    assert r["correct"] is True, r["checks"]
    # at this size K1's fixed 17 MB of scratch rows dominates the bytes a
    # byte, so only their sign is held here
    for name in METRICS + ["engine_self_ms.encode", "launch_host_ms.decode"]:
        assert r["metrics"][name]["value"] > 0, r["metrics"]
    err = capsys.readouterr().err
    assert "the step that held the most: mhc." in err
    assert not dist.is_initialized()
