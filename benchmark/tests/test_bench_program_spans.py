"""The readers of the program's spans (`engine_self_ms.*`,
`launch_host_ms.*`, `api_self_ms.*`) on synthetic traces: the union
arithmetic over nested and overlapping spans, spans outside a call left
out, and None where the trace holds none of the program's spans. On the
card (marked `cuda`): a traced run of a host cell reports all six, and
no device interval carries a span's name."""

import json
import subprocess
import sys

import pytest

from benchmark import harness, inputs, trace
from conftest import ROOT

READERS = ("engine_self_ms.encode", "engine_self_ms.decode",
           "launch_host_ms.encode", "launch_host_ms.decode",
           "api_self_ms.compress", "api_self_ms.decompress")


def _read(name, data):
    run = harness.Run(cell=harness.load_cell("markov-64k.host-1m"),
                      trace=data)
    return harness.load_metric(name).read(run)


def _resident() -> trace.TraceData:
    """Two calls a direction: (0, 100) and (200, 300) encode, (1000,
    1100) and (1200, 1300) decode (us), each holding the engine's spans;
    one engine span crosses a call's start, and one set of spans lies
    outside every call."""
    host = []
    for off, way in ((0, "encode"), (1000, "decode")):
        engine = f"mhc.engine.{way}"
        host += [
            (off + 10, off + 90, engine),
            # overlapping launches: 20-35 once
            (off + 20, off + 30, "mhc.launch.pack_units"),
            (off + 25, off + 35, "mhc.launch.markov_hist"),
            # nested: a launch inside a launch counts once
            (off + 26, off + 28, "mhc.launch.decode_lut"),
            (off + 50, off + 70, "mhc.wait.bits"),
            (off + 55, off + 60, "aten::copy_"),
            # a launch in the call, outside the engine's span
            (off + 92, off + 95, "mhc.launch.code_tables"),
            # the engine's span from before the call's start: 200-250
            (off + 190, off + 250, engine),
            (off + 240, off + 260, "mhc.wait.d2h"),
            # outside every call
            (off + 400, off + 500, engine),
            (off + 420, off + 450, "mhc.launch.pack_units"),
        ]
    return trace.TraceData(
        device=[(20, 80, "k", "kernel")],
        spans={"engine.encode": [(0, 100), (200, 300)],
               "engine.decode": [(1000, 1100), (1200, 1300)]},
        roles={"encode": "engine.encode", "decode": "engine.decode"},
        host_ops=sorted(host))


def test_engine_self_and_launch_host_ms():
    data = _resident()
    # call 1: engine 10-90 (80) less launches 20-35 (15) and the wait
    # 50-70 (20): 45; call 2: engine 200-250 (50) less the wait 240-250
    # (10): 40; the mean 42.5 us
    assert _read("engine_self_ms.encode", data) == pytest.approx(0.0425)
    assert _read("engine_self_ms.decode", data) == pytest.approx(0.0425)
    # call 1: 20-35 and 92-95 (18); call 2: none; the mean 9 us
    assert _read("launch_host_ms.encode", data) == pytest.approx(0.009)
    assert _read("launch_host_ms.decode", data) == pytest.approx(0.009)
    # no api span: nothing to read
    assert _read("api_self_ms.compress", data) is None


def test_engine_spans_in_chunks_add_up():
    """Two disjoint engine spans in one call (the api's chunks): their
    union, less the launches and waits inside them, each clipped to
    them; an engine step's own span is no engine call."""
    data = trace.TraceData(
        device=[], spans={"api.compress": [(0, 1000)]},
        roles={"encode": "api.compress"},
        host_ops=sorted([(0, 1000, "mhc.api.compress"),
                         (100, 300, "mhc.engine.encode"),
                         (150, 200, "mhc.engine.plan"),
                         (500, 600, "mhc.engine.encode"),
                         (250, 280, "mhc.launch.pack_units"),
                         (550, 700, "mhc.wait.bits")]))
    # (200 + 100) less 30 and 50 (the wait clipped to 550-600)
    assert _read("engine_self_ms.encode", data) == pytest.approx(0.220)


def test_api_self_ms():
    host = [(5, 95, "mhc.api.compress"),
            (6, 12, "mhc.api.blockify"),
            (20, 60, "mhc.api.pack"),
            (20, 60, "mhc.engine.encode"),
            (30, 40, "mhc.launch.pack_units"),
            # a launch outside the engine, overlapping a wait
            (70, 75, "mhc.launch.markov_hist"),
            (65, 80, "mhc.wait.d2h"),
            (1005, 1090, "mhc.api.decompress"),
            (1010, 1030, "mhc.engine.decode"),
            (1080, 1095, "mhc.wait.d2h"),
            # outside every call
            (2000, 2100, "mhc.api.compress")]
    data = trace.TraceData(
        device=[], spans={"api.compress": [(0, 100)],
                          "api.decompress": [(1000, 1100)]},
        roles={"encode": "api.compress", "decode": "api.decompress"},
        host_ops=sorted(host))
    # 90 less 20-60 (40) and 65-80 (15)
    assert _read("api_self_ms.compress", data) == pytest.approx(0.035)
    # 85 less 20 and 1080-1090 (10)
    assert _read("api_self_ms.decompress", data) == pytest.approx(0.055)
    assert _read("launch_host_ms.encode", data) == pytest.approx(0.015)
    assert _read("engine_self_ms.encode", data) == pytest.approx(0.030)
    # no launch in the decompress call
    assert _read("launch_host_ms.decode", data) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_no_program_span_reads_none(name):
    # the parent's trace: the harness's spans and the host's ops, no
    # `mhc.` span
    data = trace.TraceData(
        device=[(0, 10, "k", "kernel")],
        spans={"api.compress": [(0, 100)], "api.decompress": [(200, 300)],
               "engine.encode": [(400, 500)],
               "engine.decode": [(600, 700)]},
        roles={"encode": "api.compress", "decode": "api.decompress"},
        host_ops=[(5, 50, "aten::copy_"), (210, 220, "cudaMalloc")])
    assert _read(name, data) is None
    assert _read(name, None) is None
    # spans but no call in the direction
    empty = trace.TraceData(device=[], spans={}, roles={},
                            host_ops=[(0, 5, "mhc.api.compress"),
                                      (0, 5, "mhc.engine.encode"),
                                      (1, 2, "mhc.launch.pack_units")])
    assert _read(name, empty) is None


@pytest.mark.cuda
def test_traced_host_cell_reports_the_spans(card):
    """A `--trace 1` run of markov-64k.host-1m reports all six metrics,
    and no device interval of a traced window is a span of the program
    (the profiler's device-side copies of annotations stay out of the
    busy time)."""
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "markov-64k.host-1m", "--seed", str(2**31 + 1919), "--seconds",
         "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(READERS) <= set(result["metrics"]), result["metrics"]
    assert all(result["metrics"][n]["value"] > 0 for n in READERS)

    cell = harness.load_cell("markov-64k.resident-100m")
    objects = inputs.pool(1, 1 << 20, 7, cell.traffic.get("kinds"))
    entry = harness.load_entry(cell.traffic["entry"]).Entry(
        cell.config, cell.traffic, objects, card)
    harness._round_trip(entry, 0)
    sampler = harness.Sampler(7, 1, 1)
    _, data = harness.traced_window(entry, 2, sampler, 1, card)
    assert data.device
    assert not [d for d in data.device if d[2].startswith("mhc.")]
    assert any(op[2] == "mhc.engine.encode" for op in data.host_ops)
