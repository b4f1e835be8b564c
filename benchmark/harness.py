"""The benchmark's harness: one cell, one seed, one window.

A cell of BENCHMARK.json names a configuration (`configs/<name>.json`)
and a traffic mix (`traffic/<name>.json`). The mix names its entry
(`entries/<entry>.py`), which drives the program; every metric is a
reader of its own (`metrics/<name>.py`). The harness finds each by its
name, so a later cell, mix or metric is new files and new entries in
BENCHMARK.json, and no edit here.

A run: the pool of objects made from the seed (`inputs.py`), staged by
the entry; one warm-up round trip per object (the first compiles); then
either the measured window of `seconds` (`trace` 0: round trips in a
closed loop with one caller, the pool in turn, each call timed from
entry to return with its result synchronised) or the traced window
(`trace` 1: a fixed count of round trips under torch.profiler, each call
inside a span named after the layer it calls). A sample of the window's
answers, drawn from the seed, is kept on the host and judged once the
window has closed and the program's state is freed: each container
against the plain reference's (`reference/codec.py`), each decoded
object against the object itself.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from . import inputs, trace as tracing
from .reference import codec as reference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mhc_tpu")
# the sampling stream of the seed, apart from the inputs' streams
SAMPLE_STREAM = 1 << 40


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its configuration,
    its traffic mix and the metrics it reports."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(HERE, "traffic",
                                      f"{w['traffic']}.json"))

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def _load_file(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(entry: str):
    """The module `entries/<entry>.py`."""
    return _load_file(os.path.join(HERE, "entries", f"{entry}.py"),
                      f"benchmark_entry_{entry}")


def load_metric(name: str):
    """The reader `metrics/<name>.py` (its `read(run)`)."""
    return _load_file(os.path.join(HERE, "metrics", f"{name}.py"),
                      "benchmark_metric_" + name.replace(".", "_"))


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: `mhc_tpu_torch` is not `mhc_tpu`."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

@dataclass
class Window:
    """What one window did: per round trip its object, its seconds each
    way and its bytes (input, payload written, output)."""
    objects: list = field(default_factory=list)
    enc_s: list = field(default_factory=list)
    dec_s: list = field(default_factory=list)
    in_bytes: list = field(default_factory=list)
    payload_bytes: list = field(default_factory=list)
    out_bytes: list = field(default_factory=list)
    failed: int = 0
    seconds: float = 0.0

    @property
    def attempted(self) -> int:
        return len(self.objects) + self.failed

    def add(self, k, enc_s, dec_s, n_in, n_payload, n_out):
        self.objects.append(k)
        self.enc_s.append(enc_s)
        self.dec_s.append(dec_s)
        self.in_bytes.append(n_in)
        self.payload_bytes.append(n_payload)
        self.out_bytes.append(n_out)


@dataclass
class Run:
    """What a metric reader reads: the cell, the window's round trips
    (measured, or traced), the trace (None in an untraced run), the
    set-up seconds and the device's peak over the window."""
    cell: Cell
    window: Window | None = None
    trace: tracing.TraceData | None = None
    setup_s: float | None = None
    peak_bytes: int | None = None


class Sampler:
    """A sample of the window's answers, drawn from the seed: the round
    trips fall into min(size, pool) slots by object, and each slot keeps
    one of its round trips, each with the same chance (a reservoir of
    one), copied to the host by the entry's `keep`."""

    def __init__(self, seed: int, size: int, pool: int):
        self.rng = inputs.rng_for(seed, SAMPLE_STREAM)
        self.slots = max(1, min(size, pool))
        self.seen = [0] * self.slots
        self.kept = [None] * self.slots

    def offer(self, k: int, keep):
        s = k % self.slots
        self.seen[s] += 1
        if self.rng.integers(0, self.seen[s]) == 0:
            self.kept[s] = keep()

    @property
    def samples(self) -> list:
        return [x for x in self.kept if x is not None]


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _round_trip(entry, k, span=None):
    """One round trip of object k: (encoded, decoded, encode s, decode
    s), each call timed from entry to return; `span` wraps each call in
    the profiler's record_function of the entry's span name."""
    ctx = span or (lambda _name: contextlib.nullcontext())
    t0 = time.perf_counter()
    with ctx(entry.encode_span):
        enc = entry.encode(k)
    t1 = time.perf_counter()
    with ctx(entry.decode_span):
        dec = entry.decode(k, enc)
    t2 = time.perf_counter()
    return enc, dec, t1 - t0, t2 - t1


def _drive(entry, window: Window, sampler: Sampler, pool: int, i: int,
           span=None) -> None:
    k = i % pool
    try:
        enc, dec, es, ds = _round_trip(entry, k, span)
    except Exception:
        traceback.print_exc(file=sys.stderr)
        window.failed += 1
        return
    window.add(k, es, ds, entry.in_bytes(k), entry.payload_bytes(enc),
               entry.out_bytes(k, dec))
    sampler.offer(k, lambda: entry.keep(k, enc, dec))


def measured_window(entry, seconds: float, sampler: Sampler,
                    pool: int) -> Window:
    """Round trips in a closed loop for `seconds`, the pool in turn."""
    window = Window()
    i = 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        _drive(entry, window, sampler, pool, i)
        i += 1
    window.seconds = time.perf_counter() - w0
    return window


def traced_window(entry, round_trips: int, sampler: Sampler, pool: int,
                  device) -> tuple:
    """`round_trips` round trips under torch.profiler, each call in its
    span, after one round trip inside the profiler and outside any span
    (the profiler can miss its first kernels). Returns (Window,
    TraceData)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    import torch
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    window = Window()
    with profile(activities=activities) as prof:
        _round_trip(entry, 0)
        w0 = time.perf_counter()
        for i in range(round_trips):
            _drive(entry, window, sampler, pool, i, span=record_function)
        window.seconds = time.perf_counter() - w0
    roles = {"encode": entry.encode_span, "decode": entry.decode_span}
    return window, tracing.from_profiler(prof, roles)


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------

def bytes_off(got: bytes, want: bytes) -> int:
    """Bytes that differ between two byte strings, a missing or extra
    byte counting as one."""
    a = np.frombuffer(got, np.uint8)
    b = np.frombuffer(want, np.uint8)
    n = min(a.size, b.size)
    return int(np.count_nonzero(a[:n] != b[:n])) + abs(a.size - b.size)


def judge(answers: list, objects: list, config: dict) -> tuple:
    """Hold each (object index, container, decoded bytes) to the plain
    reference: the container to `reference.encode` of the object, the
    decoded bytes to the object. Returns ({check: [number, limit]},
    reference seconds)."""
    refs, ref_s = {}, 0.0
    container_off = decoded_off = 0
    for k, container, decoded in answers:
        if k not in refs:
            t = time.perf_counter()
            refs[k] = reference.encode(
                objects[k], config["mode"], config["block_size"],
                config["decode_unit"], crc=config["crc"])
            ref_s += time.perf_counter() - t
        container_off += bytes_off(container, refs[k])
        decoded_off += bytes_off(decoded, objects[k].tobytes())
    return ({"container_bytes_off": [container_off, 0],
             "decoded_bytes_off": [decoded_off, 0]}, ref_s)


def container_ratio(answers: list, objects: list) -> float:
    return (sum(len(c) for _, c, _ in answers)
            / max(1, sum(objects[k].size for k, _, _ in answers)))


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, entry_overrides=None) -> dict:
    """One run of `cell`; returns the result line's object. `t0` is the
    process's start on the perf_counter clock. `entry_overrides` (tests
    only) wraps the entry object before the run uses it."""
    import torch
    cfg, traffic = cell.config, cell.traffic
    pool = int(traffic["pool"])
    t = time.perf_counter()
    objects = inputs.pool(pool, int(traffic["object_bytes"]), seed,
                          traffic.get("kinds"))
    log(f"inputs: {pool} x {traffic['object_bytes']} B in "
        f"{time.perf_counter() - t:.4f} s")
    entry = load_entry(traffic["entry"]).Entry(cfg, traffic, objects,
                                               device)
    if entry_overrides is not None:
        entry = entry_overrides(entry)
    warm_failed = 0
    for i in range(int(traffic.get("warmup_round_trips", pool))):
        try:
            _round_trip(entry, i % pool)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            warm_failed += 1
    _sync(device)
    # the set-up's heap (torch's modules, the inputs) out of the cyclic
    # collector's reach, so a full collection in the window walks only
    # what the window allocates
    gc.collect()
    gc.freeze()
    cuda = torch.device(device).type == "cuda"
    sampler = Sampler(seed, int(traffic["sample"]), pool)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    if trace:
        window, data = traced_window(entry, int(traffic["trace_round_trips"]),
                                     sampler, pool, device)
        phases = (entry.host_phases(int(traffic["trace_round_trips"]))
                  if hasattr(entry, "host_phases") else [])
        data.host_phases = phases
        run_ = Run(cell=cell, window=window, trace=data, setup_s=setup_s)
        metrics_of = cell.per_layer
    else:
        window = measured_window(entry, seconds, sampler, pool)
        run_ = Run(cell=cell, window=window, setup_s=setup_s)
        metrics_of = cell.end_to_end
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run_.peak_bytes = peak
    log(f"setup_s {setup_s:.6f}; window {window.seconds:.6f} s, "
        f"{len(window.objects)} round trips, {window.failed} failed")
    if window.enc_s:
        rts = [1e3 * (a + b) for a, b in zip(window.enc_s, window.dec_s)]
        log(f"round trip ms: median {statistics.median(rts):.6f}, "
            f"p95 {float(np.percentile(rts, 95)):.6f}, n {len(rts)}")
        # a window that warms up or slows down reads unlike in its halves
        h = len(rts) // 2
        for label, sl in (("first", slice(0, h)), ("second", slice(h, None))):
            if window.enc_s[sl]:
                log(f"{label} half: encode "
                    f"{sum(window.in_bytes[sl]) / sum(window.enc_s[sl]) / 1e9:.6f}"
                    f" GB/s, decode "
                    f"{sum(window.out_bytes[sl]) / sum(window.dec_s[sl]) / 1e9:.6f}"
                    " GB/s")
    metrics = {}
    for m in metrics_of:
        value = load_metric(m["name"]).read(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the program's answers to the host, its state freed, then the
    # reference
    answers = [entry.judge(s) for s in sampler.samples]
    extra = entry.guarantees(sampler.samples) if hasattr(
        entry, "guarantees") else {}
    entry.close()
    del entry
    if cuda:
        torch.cuda.empty_cache()
    checks, ref_s = judge(answers, objects, cfg)
    log(f"reference: {len(answers)} answers judged in {ref_s:.4f} s; "
        f"container ratio {container_ratio(answers, objects):.6f}")
    checks = {"calls_failed": [window.failed + warm_failed, 0], **checks,
              **extra}
    ok = bool(answers) and all(v <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = run_.trace.busy_s
        device_info["window_s"] = run_.trace.window_s
    result = {"correct": ok, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = run_.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
