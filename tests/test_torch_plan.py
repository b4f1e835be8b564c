"""The engine's unit plans: the host library's one pass each way
(`utils/unit_plan.cpp`) against the format's rules, stated here in numpy
with the JAX package's helpers.

Each case plans units and compares every output with the rules': the
encode's bit lengths, container-layout bytes, total words and upload
buffer (word offsets, literal flags); the decode's row width, literal
count and upload buffer (code lengths, offsets, n_dec, literal rows),
for an engine result and for parsed containers of either layout.
Corrupt unit lengths raise ValueError before anything is uploaded, and
without the host library the plans raise RuntimeError.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from mhc_tpu import container as jax_container
from mhc_tpu.ops import bitpack as jax_bitpack
from mhc_tpu_torch import container, engine
from mhc_tpu_torch.ops import bitpack
from tests.corpus import english_like
from tests.torch_fixtures import no_host_library  # noqa: F401

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


def _n_valid(orig_len: int, du: int, R: int) -> np.ndarray:
    """Each unit's bytes of `orig_len` cut into `du`-byte units; 0 past
    the end."""
    return np.clip(orig_len - np.arange(R, dtype=np.int64) * du, 0, du)


def _staged(*arrays) -> tuple:
    """The upload buffer of `arrays` laid back to back at 8-byte aligned
    offsets, zero between them, and [(offset, array)]."""
    buf, parts = b"", []
    for a in arrays:
        parts.append((len(buf), a))
        raw = a.tobytes()
        buf += raw + bytes(-len(raw) % 8)
    return np.frombuffer(buf, np.uint8), parts


def _encode_rules(bits, st, aligned: bool):
    """The encode's plan: a unit under a block is stored as its bytes
    where its coded stream takes at least as much of the container layout
    (whole words aligned, else bytes), its bits then 8 per byte."""
    R = len(bits)
    b = bits.astype(np.int64)
    nv = _n_valid(st.orig_len, st.decode_unit, R)
    layout = ((b + 31) // 32 >= (nv + 3) // 4 if aligned
              else (b + 7) // 8 >= nv)
    raw = layout & (st.decode_unit != st.block_size)
    bit_lens = np.where(raw, nv * 8, b)
    byte_lens = jax_container.stream_byte_lens(
        bit_lens, container.MODE_MARKOV if aligned
        else container.MODE_ORDER0).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum((bit_lens + 31) // 32)])
    buf, parts = _staged(bounds.astype(np.int64), raw.astype(np.uint8))
    return bit_lens, byte_lens, int(bounds[-1]), buf, parts


def _decode_rules(enc):
    """The decode's plan, or the error of a unit length no encoder
    writes: over its stream row's words_for_block(du) words (aligned) or
    ceil(du * 15 / 8) bytes, or under a bit a symbol, 4 * ceil(m / 32)
    bytes (aligned) or ceil(m / 8), m the unit's symbols. A literal is a
    unit of the substream layout whose stored length is its bytes' (in
    words, aligned); it decodes no symbols."""
    du, R, aligned = enc.decode_unit, enc.n_units, enc.aligned
    sl = np.asarray(enc.byte_lens, np.int64)
    if R:
        m = np.full(R, du, np.int64)
        m[-1] = enc.orig_len - (R - 1) * du
        worst = (4 * jax_bitpack.words_for_block(du) if aligned
                 else -(-du * 15 // 8))
        least = 4 * -(-m // 32) if aligned else -(-m // 8)
        if sl.max() > worst or (sl < least).any():
            return "mhc: corrupt container (unit length)"
    if enc.bit_lens is None and not aligned:
        lens = sl                       # bytes, expanded bytewise (K12)
        W = int(-(-sl.max() // 4)) + 1 if R else 1
    else:
        lens = ((enc.bit_lens + 31) // 32 if enc.bit_lens is not None
                else sl // 4)
        W = int(lens.max()) + 1 if R else 1
    nv = _n_valid(enc.orig_len, du, R)
    raw = (jax_bitpack.raw_unit_mask(sl, nv, aligned) & (nv > 0)
           & enc.raw_units & (du != enc.block_size))
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    rows = np.flatnonzero(raw).astype(np.int64)
    buf, parts = _staged(np.asarray(enc.lengths, np.uint8), bounds,
                         np.where(raw, 0, nv).astype(np.int32), rows)
    return W, len(rows), buf, parts


def _encode_plan(bits, st, aligned):
    bit_lens, byte_lens, total, (buf, parts) = engine._encode_plan(
        bits, st, aligned)
    # the staging buffer is the thread's: copy it before the next plan
    return (bit_lens, byte_lens, total, buf.copy(),
            [(s, v.copy()) for s, v in parts])


def _decode_plan(enc):
    try:
        W, n_raw, (buf, parts) = engine._decode_plan(enc)
    except ValueError as e:
        return str(e)
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
def test_native_plan_equals_reference(mode, case, source):
    """The native plans give the rules' arrays and upload bytes, each
    way: the literal rule at its threshold and one bit below it, a short
    last unit, rows past the end (literals of 0 bits on the encode; the
    decode's length check refuses all but a last one), no units, one
    unit, units equal to the block (no literal rule), and offsets past
    2**31 bytes at 294,914 units. The decode plans an engine result (bit
    lengths), or the same units as parsed from a container (stored bytes
    alone), with and without the literal flag."""
    R, du, block, orig_len = CASES[case]
    aligned = MODES[mode]
    st = engine.Staged(mode=mode, block_size=block, decode_unit=du,
                       orig_len=orig_len, n_units=R, units=None,
                       n_valid=None)
    bits = _bits(R, du, orig_len, aligned)
    enc_plan = _encode_plan(bits, st, aligned)
    _same(enc_plan, _encode_rules(bits, st, aligned))
    bit_lens, byte_lens = enc_plan[:2]
    nv = engine.host_n_valid(orig_len, du, R)
    if du != block and R:
        flags = enc_plan[4][1][1]
        assert flags[nv == 0].all()
    enc = engine.EncodeResult(
        mode=mode, block_size=block, decode_unit=du, orig_len=orig_len,
        n_units=R,
        lengths=np.full((256, 256) if aligned else (256,), 8, np.uint8),
        byte_lens=byte_lens,
        bit_lens=bit_lens if source == "result" else None,
        payload=torch.zeros(1, dtype=torch.int32),
        raw_units=source != "parsed_no_raw", aligned=aligned)
    dec_plan = _decode_plan(enc)
    _same(dec_plan, _decode_rules(enc))
    if case not in ("rows_past_the_end", "no_units"):
        W, n_raw = dec_plan[:2]
        assert W >= 1 and n_raw == (
            int((bit_lens == 8 * nv)[nv > 0].sum())
            if du != block and source != "parsed_no_raw" else 0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["too_long", "too_short", "negative"])
def test_corrupt_unit_lengths_raise_before_the_upload(monkeypatch, kind,
                                                      mode):
    """Above the longest stream of either layout, under a bit a symbol,
    or negative: the plan refuses the length before the upload."""
    data = english_like(9_000, seed=22)
    st = engine.stage(data, mode=mode, decode_unit=1024, device="cpu")
    enc = engine.encode(st)
    lens = enc.byte_lens.copy()
    lens[3] = {"too_long": 4 * (bitpack.words_for_block(1024) + 1),
               "too_short": 4, "negative": -4}[kind]
    enc.byte_lens, enc.bit_lens = lens, None

    def refuse(*args, **kwargs):
        raise AssertionError("the plan was uploaded")

    monkeypatch.setattr(engine, "upload_staged", refuse)
    monkeypatch.setattr(engine, "upload", refuse)
    with pytest.raises(ValueError,
                       match=r"^mhc: corrupt container \(unit length\)$"):
        engine.decode(enc)


@pytest.mark.parametrize("step", ["plan", "writer"])
def test_the_plans_and_the_writer_raise_without_the_library(
        no_host_library, step):
    """The host library is required as nvcc is: where it cannot be
    built, the engine's plans (its encode's and its decode's) and the
    container writer raise RuntimeError with the compiler's output."""
    data = english_like(20_000, seed=23) + bytes(range(256)) * 20
    st = engine.stage(data, decode_unit=1024, device="cpu")
    enc = engine.encode(st)
    payload = engine.fetch_payload(enc)
    no_host_library()
    failed = pytest.raises(RuntimeError, match=r"g\+\+ failed")
    if step == "plan":
        with failed:
            engine.encode(st, lengths=enc.lengths)
        with failed:
            engine.decode(enc)
    else:
        with failed:
            container.build_container(
                container.MODE_MARKOV, len(data), st.block_size,
                enc.lengths, enc.bit_lens, payload, None,
                decode_unit=st.decode_unit)


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
