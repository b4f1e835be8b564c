"""`benchmark/run.py` exits non-zero, with no result line and before any
timing, without a card; and, with the timed path broken underneath, a
run's `correct` comes out false, once for each fault a cell can have,
while a sound run's comes out true. The controls come out not correct."""

import dataclasses
import os
import subprocess
import sys
import time

import pytest

from conftest import ROOT
from benchmark import control, harness

CELLS = ["markov-64k.resident-100m", "order0-64k.resident-100m",
         "markov-64k.host-1m", "markov-64k.host-100m"]


def test_run_exits_without_a_card_before_any_timing():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", str(2**31 + 3), "--seconds",
                        "10", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA card" in r.stderr
    assert "[bench]" not in r.stderr
    assert time.perf_counter() - t < 120


def small(name: str, **traffic):
    cell = harness.load_cell(name)
    return dataclasses.replace(cell, traffic={
        **cell.traffic, "object_bytes": 65536 + 8193, "pool": 2,
        "warmup_round_trips": 1, "trace_round_trips": 1, **traffic})


class Broken:
    """The entry with one fault planted in the timed path."""

    def __init__(self, entry, fault: str):
        self.entry, self.fault = entry, fault

    def __getattr__(self, name):
        return getattr(self.entry, name)

    def encode(self, k):
        enc = self.entry.encode(k)
        if self.fault != "altered_encode":
            return enc
        if isinstance(enc, bytes):           # host: a container byte
            b = bytearray(enc)
            b[len(b) // 2] ^= 0x10
            return bytes(b)
        payload = enc.payload.clone()        # resident: a payload word
        payload[payload.numel() // 2] ^= 0x10
        return dataclasses.replace(enc, payload=payload)

    def decode(self, k, enc):
        out = self.entry.decode(k, enc)
        if self.fault == "altered_decode":
            if isinstance(out, bytes):
                b = bytearray(out)
                b[len(b) // 3] ^= 0x01
                return bytes(b)
            out = out.clone()
            out.view(-1)[out.numel() // 3] ^= 1
        elif self.fault == "half_batch":
            # half the rows (host: bytes) left out, as zeros
            if isinstance(out, bytes):
                h = len(out) // 2
                return out[:h] + bytes(len(out) - h)
            out = out.clone()
            out[out.shape[0] // 2:] = 0
        return out


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, "altered_encode", "altered_decode",
                                   "half_batch"])
def test_a_fault_in_the_timed_path_makes_correct_false(name, fault):
    wrap = (lambda e: Broken(e, fault)) if fault else None
    r = harness.run(small(name), 2**31 + 77, 0.05, False, "cpu",
                    time.perf_counter(), entry_overrides=wrap)
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    # a noise part among counters: its units are stored as literals
    cell = small(name, object_bytes=4 * 65536, kinds={"noise": 0.25,
                                                      "counters": 0.75})
    for seed in (1, 2**31 + 5, 2**33 + 9):
        out = control.control_run(cell, seed)
        assert out["correct"] is False, out
        assert out["checks"]["container_bytes_off"]["value"] > 0
        # the reference itself, in the same place, is correct
        ref = control.control_run(cell, seed, control="none")
        assert ref["correct"] is True, ref
