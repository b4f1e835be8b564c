"""The engine's unit plans: the host library's one pass each way
(`utils/unit_plan.cpp`) against the numpy route it replaces, which runs
where the library does not load.

Each case plans the same units both ways and compares every output: the
encode's bit lengths, container-layout bytes, total words and upload
buffer (word offsets, literal flags); the decode's row width, literal
count and upload buffer (code lengths, offsets, n_dec, literal rows),
for an engine result and for parsed containers of either layout. Corrupt
unit lengths raise the same ValueError on both routes before anything
is uploaded, and `engine.PLANS` names the route that ran.
"""

import os
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from mhc_tpu_torch import api, container, engine
from mhc_tpu_torch.ops import bitpack
from mhc_tpu_torch.utils import native
from tests.corpus import english_like

MODES = {"markov": True, "huffman": False}   # mode -> aligned layout

# name -> (units, decode unit, block size, orig_len)
CASES = {
    "short_last_unit": (37, 1024, 65536, 36 * 1024 + 100),
    "du_is_block": (9, 4096, 4096, 8 * 4096 + 7),
    "one_row_past_the_end": (11, 1024, 65536, 10 * 1024),
    "rows_past_the_end": (14, 1024, 65536, 10 * 1024 + 5),
    "no_units": (0, 1024, 65536, 0),
    "one_unit": (1, 1024, 65536, 700),
    "past_2_31": (294_914, 8192, 65536, 2_415_931_449),
}


def _bits(R: int, du: int, orig_len: int, aligned: bool) -> np.ndarray:
    """(R,) int32 coded bit counts a unit can have, a fifth of them
    exactly on the literal rule's threshold (the fewest bits that make
    the unit a literal) and a fifth one bit below it; rows past the end
    code 0 bits."""
    rng = np.random.default_rng(R)
    nv = engine.host_n_valid(orig_len, du, R)
    least_literal = (32 * ((nv + 3) // 4 - 1) + 1 if aligned
                     else 8 * (nv - 1) + 1)
    bits = rng.integers(nv, 15 * nv + 1)
    bits[::5] = least_literal[::5]
    bits[1::5] = np.maximum(least_literal[1::5] - 1, nv[1::5])
    return np.where(nv > 0, bits, 0).astype(np.int32)


def _route(monkeypatch, route: str) -> None:
    if route == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)


def _encode_plan(monkeypatch, route, bits, st, aligned):
    with monkeypatch.context() as m:
        _route(m, route)
        engine.PLANS.clear()
        bit_lens, byte_lens, total, (buf, parts) = engine._encode_plan(
            bits, st, aligned)
        assert engine.PLANS == {route: 1}
    # the staging buffer is the thread's: copy it before the next plan
    return (bit_lens, byte_lens, total, buf.copy(),
            [(s, v.copy()) for s, v in parts])


def _decode_plan(monkeypatch, route, enc):
    with monkeypatch.context() as m:
        _route(m, route)
        engine.PLANS.clear()
        try:
            W, n_raw, (buf, parts) = engine._decode_plan(enc)
        except ValueError as e:
            return str(e)
        assert engine.PLANS == {route: 1}
    return W, n_raw, buf.copy(), [(s, v.copy()) for s, v in parts]


def _same(a, b) -> None:
    if isinstance(a, str) or isinstance(b, str):
        assert a == b
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _same([s for s, _ in x], [s for s, _ in y])
            for (_, u), (_, v) in zip(x, y):
                assert u.dtype == v.dtype and u.shape == v.shape
                np.testing.assert_array_equal(u, v)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert type(x) is type(y) and x == y


@pytest.mark.parametrize("source", ["result", "parsed", "parsed_no_raw"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", list(MODES))
def test_native_plan_equals_numpy_plan(monkeypatch, mode, case, source):
    """Both routes give the same arrays and upload bytes, each way: the
    literal rule at its threshold and one bit below it, a short last
    unit, rows past the end (literals of 0 bits on the encode; the
    decode's length check refuses all but a last one, on both routes),
    no units, one unit, units equal to the block (no literal rule), and
    offsets past 2**31 bytes at 294,914 units. The decode plans an
    engine result (bit lengths), or the same units as parsed from a
    container (stored bytes alone), with and without the literal flag."""
    R, du, block, orig_len = CASES[case]
    aligned = MODES[mode]
    st = engine.Staged(mode=mode, block_size=block, decode_unit=du,
                       orig_len=orig_len, n_units=R, units=None,
                       n_valid=None)
    bits = _bits(R, du, orig_len, aligned)
    enc_plans = [_encode_plan(monkeypatch, route, bits, st, aligned)
                 for route in ("native", "numpy")]
    _same(*enc_plans)
    bit_lens, byte_lens, total = enc_plans[0][:3]
    assert total == int(((bit_lens + 31) // 32).sum())
    np.testing.assert_array_equal(byte_lens, container.stream_byte_lens(
        bit_lens, container.MODE_MARKOV if aligned
        else container.MODE_ORDER0))
    nv = engine.host_n_valid(orig_len, du, R)
    if du != block and R:
        flags = enc_plans[0][4][1][1]
        assert flags[nv == 0].all()
        assert (bit_lens[flags == 1] == 8 * nv[flags == 1]).all()
    enc = engine.EncodeResult(
        mode=mode, block_size=block, decode_unit=du, orig_len=orig_len,
        n_units=R,
        lengths=np.full((256, 256) if aligned else (256,), 8, np.uint8),
        byte_lens=byte_lens,
        bit_lens=bit_lens if source == "result" else None,
        payload=torch.zeros(1, dtype=torch.int32),
        raw_units=source != "parsed_no_raw", aligned=aligned)
    dec_plans = [_decode_plan(monkeypatch, route, enc)
                 for route in ("native", "numpy")]
    _same(*dec_plans)
    if case not in ("rows_past_the_end", "no_units"):
        W, n_raw = dec_plans[0][:2]
        assert W >= 1 and n_raw == (
            int((bit_lens == 8 * nv)[nv > 0].sum())
            if du != block and source != "parsed_no_raw" else 0)


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["too_long", "too_short", "negative"])
def test_corrupt_unit_lengths_raise_before_the_upload(monkeypatch, kind,
                                                      route):
    data = english_like(9_000, seed=22)
    st = engine.stage(data, decode_unit=1024, device="cpu")
    enc = engine.encode(st)
    lens = enc.byte_lens.copy()
    lens[3] = {"too_long": 4 * (bitpack.words_for_block(1024) + 1),
               "too_short": 4, "negative": -4}[kind]
    enc.byte_lens, enc.bit_lens = lens, None

    def refuse(*args, **kwargs):
        raise AssertionError("the plan was uploaded")

    _route(monkeypatch, route)
    monkeypatch.setattr(engine, "upload_staged", refuse)
    monkeypatch.setattr(engine, "upload", refuse)
    engine.PLANS.clear()
    with pytest.raises(ValueError,
                       match=r"^mhc: corrupt container \(unit length\)$"):
        engine.decode(enc)
    assert engine.PLANS == {}


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_plans_count_their_route(monkeypatch, route):
    """An engine round trip and an api one count one plan each way by
    the route that ran, and both routes write the same bytes."""
    data = english_like(20_000, seed=23) + bytes(range(256)) * 20
    want = api.compress(data, decode_unit=1024, device="cpu")
    _route(monkeypatch, route)
    engine.PLANS.clear()
    st = engine.stage(data, decode_unit=1024, device="cpu")
    enc = engine.encode(st)
    assert engine.fetch_bytes(enc, engine.decode(enc)) == data
    assert engine.assemble_container(enc, zlib.crc32(data)) == want
    assert engine.PLANS == {route: 2}
    blob = api.compress(data, decode_unit=1024, device="cpu")
    assert blob == want and api.decompress(blob, device="cpu") == data
    assert engine.PLANS == {route: 4}
    assert native.available() or route == "numpy"



def test_threads_plan_in_their_own_staging_buffers():
    """Threads planning and uploading at once, more than the cores, with
    the interpreter switching threads often: each plan is staged in its
    thread's buffer, so every upload holds its own plan (a buffer shared
    by the threads would hand one thread another's offsets)."""
    n = 2 * (os.cpu_count() or 4)
    R, du, orig_len = 20_000, 1024, 20_000 * 1024 - 77
    plans = []
    for i in range(n):
        st = engine.Staged(mode="markov", block_size=65536, decode_unit=du,
                           orig_len=orig_len - i, n_units=R, units=None,
                           n_valid=None)
        plans.append(st)
    bits = [_bits(R, du, st.orig_len, True) for st in plans]

    def plan_and_upload(i):
        st = plans[i]
        bit_lens, byte_lens, _, staged = engine._encode_plan(bits[i], st,
                                                             True)
        up = engine.upload_staged("cpu", *staged)
        enc = engine.EncodeResult(
            mode="markov", block_size=65536, decode_unit=du,
            orig_len=st.orig_len, n_units=R,
            lengths=np.full((256, 256), 8, np.uint8), byte_lens=byte_lens,
            bit_lens=bit_lens, payload=torch.zeros(1, dtype=torch.int32))
        _, _, staged = engine._decode_plan(enc)
        return [t.numpy().copy() for t in
                up + engine.upload_staged("cpu", *staged)]

    want = [plan_and_upload(i) for i in range(n)]
    wrong = []
    start = threading.Barrier(n)

    def work(i):
        start.wait()
        for _ in range(20):
            got = plan_and_upload(i)
            if not all(np.array_equal(a, b) for a, b in zip(got, want[i])):
                wrong.append(i)
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not wrong
