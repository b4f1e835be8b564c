"""The program's spans (`utils.metrics.span`) on the CPU: the off path is
one shared no-op context; under torch.profiler the engine's and the
api's spans are `record_function` ranges nested in the caller's range,
in both modes and for every pack method; a `tracing()` records the same
spans with their parents; and neither changes a byte of the output."""

import json
import threading
from contextlib import nullcontext

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mhc_tpu_torch import api, engine
from mhc_tpu_torch.utils import metrics
from tests.corpus import mixed_binary
from tests.torch_fixtures import one_torch_thread  # noqa: F401

# on the CPU each kernel wrapper's span holds its plain version; the
# table build is the host's, then K13's wrapper
ENGINE_ENCODE = {"mhc.engine.encode", "mhc.engine.tables", "mhc.engine.pack",
                 "mhc.wait.bits", "mhc.engine.plan", "mhc.engine.upload",
                 "mhc.engine.compact", "mhc.launch.canonical_tables",
                 "mhc.launch.compact_units"}
HISTOGRAM = {"markov": "mhc.launch.markov_hist",
             "huffman": "mhc.launch.order0_hist"}
PACK = {"fused": {"mhc.launch.pack_units"},
        "dense": {"mhc.launch.lookup_cl", "mhc.launch.pack_cl"},
        "pallas": {"mhc.launch.lookup_cl", "mhc.launch.bubble_pack",
                   "mhc.launch.compact_bubbles"}}
ENGINE_DECODE = {"mhc.engine.decode", "mhc.engine.decode_plan",
                 "mhc.engine.upload", "mhc.engine.tables",
                 "mhc.engine.expand", "mhc.engine.rows",
                 "mhc.launch.canonical_tables", "mhc.launch.expand_units"}
DECODE_UNITS = {"markov": "mhc.launch.decode_units",
                "huffman": "mhc.launch.decode_units_order0"}
API_COMPRESS = {"mhc.api.compress", "mhc.api.blockify", "mhc.api.h2d",
                "mhc.api.tables", "mhc.api.crc32", "mhc.api.pack",
                "mhc.api.d2h", "mhc.api.join", "mhc.wait.d2h",
                "mhc.api.container"}
API_DECOMPRESS = {"mhc.api.decompress", "mhc.api.parse", "mhc.api.h2d",
                  "mhc.api.decode", "mhc.api.d2h", "mhc.api.join",
                  "mhc.wait.d2h", "mhc.api.crc32"}


def test_off_path_is_the_shared_nullcontext(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = metrics.span("mhc.api.compress", 10)
    assert isinstance(off, nullcontext)
    assert metrics.span("mhc.launch.pack_units") is off
    data = mixed_binary(20_000, seed=3)
    blob = api.compress(data, device="cpu")
    assert api.decompress(blob, device="cpu") == data
    # a trace alone records without the profiler
    with metrics.tracing() as tr:
        assert metrics.span("mhc.api.compress") is not off
        api.compress(data, device="cpu")
    assert tr.spans[0].name == "mhc.api.compress"
    assert metrics.span("mhc.api.compress") is off


def _ranges(prof, prefix: str = "mhc.") -> list:
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(prefix)]


def _inside(prof, outer: str, want: set) -> None:
    """Every `mhc.*` range of the profile lies in the one range `outer`,
    and their names are `want`."""
    (o,) = [r for r in _ranges(prof, outer) if r[0] == outer]
    inner = _ranges(prof)
    assert {n for n, _, _ in inner} == want
    assert all(o[1] <= s <= e <= o[2] for _, s, e in inner), (o, inner)


def _parents(tr) -> set:
    """(span, parent) name pairs of a trace; None for a top-level one."""
    return {(s.name, tr.spans[s.parent].name if s.parent is not None
             else None) for s in tr.spans}


@pytest.mark.parametrize("pack_method", ["fused", "dense", "pallas"])
@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_spans_nest_in_the_callers_range(mode, pack_method):
    # 79 units of 256 B, 32 a chunk: three chunks, so the api's per-chunk
    # phases run more than once; short units keep the plain decode's
    # loop over a unit's symbols (each step some twenty profiled ops) short
    data = mixed_binary(20_001, seed=19)
    kw = dict(mode=mode, block_size=4096, decode_unit=256)
    chunk = 8 << 10
    plain = api.compress(data, device="cpu", pack_method=pack_method, **kw)
    st = engine.stage(data, device="cpu", **kw)
    plain_enc = engine.encode(st, pack_method=pack_method)
    plain_rows = engine.decode(plain_enc)

    encode_spans = ENGINE_ENCODE | {HISTOGRAM[mode]} | PACK[pack_method]
    decode_spans = ENGINE_DECODE | {DECODE_UNITS[mode]}

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("engine.encode"):
            enc = engine.encode(st, pack_method=pack_method)
    _inside(prof, "engine.encode", encode_spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("engine.decode"):
            rows = engine.decode(enc)
    _inside(prof, "engine.decode", decode_spans)
    assert torch.equal(enc.payload, plain_enc.payload)
    assert (enc.byte_lens == plain_enc.byte_lens).all()
    assert torch.equal(rows, plain_rows)

    old = api.CHUNK_BYTES
    api.CHUNK_BYTES = chunk
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                metrics.tracing() as tr:
            with record_function("api.compress"):
                blob = api.compress(data, device="cpu",
                                    pack_method=pack_method, **kw)
        _inside(prof, "api.compress", API_COMPRESS | encode_spans)
        enc_tr = tr
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                metrics.tracing() as tr:
            with record_function("api.decompress"):
                out = api.decompress(blob, device="cpu")
        _inside(prof, "api.decompress", API_DECOMPRESS | decode_spans)
    finally:
        api.CHUNK_BYTES = old
    assert blob == plain and out == data

    # the trace's parents: each layer inside the one that calls it
    assert {("mhc.api.compress", None), ("mhc.api.pack", "mhc.api.compress"),
            ("mhc.engine.encode", "mhc.api.pack"),
            ("mhc.wait.bits", "mhc.engine.encode"),
            ("mhc.launch.compact_units", "mhc.engine.compact"),
            (HISTOGRAM[mode], "mhc.api.tables"),
            ("mhc.launch.lookup_cl" if pack_method != "fused"
             else "mhc.launch.pack_units", "mhc.engine.pack"),
            ("mhc.api.join", "mhc.api.d2h"),
            ("mhc.wait.d2h", "mhc.api.d2h")} <= _parents(enc_tr)
    assert {("mhc.api.decompress", None),
            ("mhc.api.parse", "mhc.api.decompress"),
            ("mhc.engine.decode", "mhc.api.decode"),
            ("mhc.engine.decode_plan", "mhc.engine.decode"),
            ("mhc.launch.expand_units", "mhc.engine.expand"),
            (DECODE_UNITS[mode], "mhc.engine.rows"),
            ("mhc.api.join", "mhc.api.d2h")} <= _parents(tr)
    assert {s.call for s in enc_tr.spans} == {s.call for s in tr.spans} \
        == {0}
    phases = enc_tr.report()
    assert phases["pack"]["calls"] == phases["blockify"]["calls"] == 3
    assert tr.report()["decode"]["calls"] == 3
    assert tr.report()["parse"]["calls"] == 1


def test_concurrent_calls_trace_apart():
    """Two threads compressing at once, each in its own trace: each
    trace holds its own call's spans alone."""
    datas = {"a": mixed_binary(40_000, seed=1), "b": mixed_binary(90_000,
                                                                 seed=2)}
    traces, blobs, errors = {}, {}, []

    def work(k):
        try:
            with metrics.tracing() as tr:
                blobs[k] = api.compress(datas[k], device="cpu")
            traces[k] = tr
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in datas]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for k, tr in traces.items():
        tops = [s for s in tr.spans if s.parent is None]
        assert [(s.name, s.nbytes) for s in tops] == [
            ("mhc.api.compress", len(datas[k]))]
        assert {s.call for s in tr.spans} == {0}
        assert tr.report()["crc32"]["bytes"] == len(datas[k])
        assert blobs[k] == api.compress(datas[k], device="cpu")


def test_mhc_trace_records_into_the_callers_trace(monkeypatch, capsys):
    """With `MHC_TRACE` set inside a caller's `tracing()`, the calls'
    spans go into the caller's trace, under the caller's own span, and
    each call's line reports that call's phases alone."""
    datas = [mixed_binary(30_000, seed=7), mixed_binary(50_000, seed=8)]
    monkeypatch.setenv("MHC_TRACE", "1")
    with metrics.tracing() as tr:
        with metrics.span("mhc.caller"):
            blobs = [api.compress(d, device="cpu") for d in datas]
        assert api.decompress(blobs[1], device="cpu") == datas[1]
    lines = [json.loads(line.split("] ", 1)[1])
             for line in capsys.readouterr().err.splitlines()
             if line.startswith("[mhc-trace ")]
    assert len(lines) == 3
    tops = [i for i, s in enumerate(tr.spans)
            if s.name in ("mhc.api.compress", "mhc.api.decompress")]
    assert [tr.spans[i].parent for i in tops] == [0, 0, None]
    assert [tr.spans[i].nbytes for i in tops] == [
        len(datas[0]), len(datas[1]), len(blobs[1])]
    for i, line in zip(tops, lines):
        assert line == json.loads(tr.dumps(omit=("parse",), root=i))
    assert [line["crc32"]["bytes"] for line in lines] == [
        len(datas[0]), len(datas[1]), len(datas[1])]
    assert set(lines[0]) == {"blockify", "h2d", "tables", "crc32", "pack",
                             "d2h", "container"}
    # the calls under the caller's span share its call id
    assert {tr.spans[i].call for i in tops} == {0, 1}
