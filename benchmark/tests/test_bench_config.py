"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix and metric resolves by its name; a new one is
new files and new entries, with no edit to a file that is there."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter",
           "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text, most=200):
    return (isinstance(text, str) and 1 <= len(text) <= most
            and "\n" not in text and "\t" not in text)


def test_benchmark_json_keys_names_and_units():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    b = bench()
    assert set(b) == KEYS["top"]
    assert 1 <= len(b["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and not p.endswith("_torch")
               for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = set()
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"]
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    metric_names = []
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert set(m) - {"workloads"} == KEYS[kind]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            metric_names.append(m["name"])
    assert len(set(metric_names)) == len(metric_names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    b = bench()
    for w in b["workloads"]:
        n = w["name"]
        e2e = [m["name"] for m in b["end_to_end"] if reports(m, n)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in b["per_layer"] if reports(m, n)]
        assert layers
        for m in layers:
            assert m["moves"] in e2e


def test_every_cell_resolves_to_its_files():
    from benchmark import harness
    b = bench()
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        entry = harness.load_entry(cell.traffic["entry"])
        assert hasattr(entry, "Entry")
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_metric(m["name"]).read)
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" in base:
                continue
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_cell_config_mix_and_metric_are_new_files(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root)
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs", "markov-64k.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "markov-4k"
    cfg["block_size"] = 4096
    cfg["decode_unit"] = 1024
    with open(os.path.join(bdir, "configs", "markov-4k.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bdir, "traffic", "host-64k.json"), "w") as f:
        json.dump({"entry": "host", "object_bytes": 65536, "pool": 2,
                   "kinds": {"noise": 1.0}, "warmup_round_trips": 1,
                   "trace_round_trips": 2, "sample": 2,
                   "control": "no_crc"}, f)
    with open(os.path.join(bdir, "metrics", "calls_per_s.py"), "w") as f:
        f.write("def read(run):\n    w = run.window\n"
                "    return len(w.objects) / w.seconds\n")
    b = bench(root)
    b["configs"].append({"name": "markov-4k", "source": "a test",
                         "file": "benchmark/configs/markov-4k.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "markov-4k.host-64k",
                           "config": "markov-4k", "traffic": "host-64k",
                           "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "calls_per_s", "unit": "1/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["markov-4k.host-64k"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark import harness\n"
        "c = harness.load_cell('markov-4k.host-64k')\n"
        "assert c.config['block_size'] == 4096, c.config\n"
        "assert c.traffic['object_bytes'] == 65536\n"
        "names = [m['name'] for m in c.end_to_end]\n"
        "assert 'calls_per_s' in names and 'setup_s' in names, names\n"
        "for m in c.end_to_end + c.per_layer:\n"
        "    harness.load_metric(m['name']).read\n"
        "harness.load_entry(c.traffic['entry']).Entry\n"
        "print('resolved')\n")
    # the copy's benchmark first; the program from the repo
    env = {**os.environ, "PYTHONPATH": ROOT}
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "resolved" in r.stdout
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
