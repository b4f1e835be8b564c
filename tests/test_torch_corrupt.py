"""Corruption robustness of the port (tests/test_corrupt.py against
mhc_tpu_torch): a damaged container raises a clean ValueError or returns
the right bytes, never other bytes and never another exception. 1 KB
decode units keep the CPU's plain decode short. A container whose length
index is rewritten so that one unit claims the whole payload still
parses; the decoders raise before they size a buffer by the claim. The
crafted containers of chip_smoke.py (over-full code lengths, unit
lengths under what a unit's symbols take, negative or past 2**63) are
refused by every route, before any decode."""

import json
import os
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from mhc_tpu import container as jax_container
from mhc_tpu_torch import api, container, engine, hybrid
from mhc_tpu_torch.models.entropy import get_model
from mhc_tpu_torch.ops import bitpack
from mhc_tpu_torch.utils import native
from tests.corpus import ADVERSARIAL, english_like, mixed_binary

DATA = english_like(60_000, seed=77)


@pytest.fixture(scope="module")
def blob():
    return api.compress(DATA, mode="markov", block_size=1024, device="cpu")


def _try(blob_bytes):
    try:
        out = api.decompress(bytes(blob_bytes), device="cpu")
    except ValueError:
        return "error"
    except Exception as e:  # noqa: BLE001
        raise AssertionError(f"non-ValueError escaped: "
                             f"{type(e).__name__}: {e}")
    return "ok" if out == DATA else "WRONG"


def test_truncation_every_boundary(blob):
    for cut in [0, 1, 7, 8, 23, 24, 100, len(blob) // 2, len(blob) - 5,
                len(blob) - 1]:
        assert _try(blob[:cut]) == "error", cut


def test_random_truncations(blob):
    rng = np.random.default_rng(0)
    for _ in range(25):
        cut = int(rng.integers(0, len(blob)))
        assert _try(blob[:cut]) == "error", cut


def test_bit_flips_everywhere(blob):
    rng = np.random.default_rng(1)
    arr = np.frombuffer(blob, np.uint8).copy()
    for _ in range(40):
        pos = int(rng.integers(0, arr.size))
        mutated = arr.copy()
        mutated[pos] ^= 1 << int(rng.integers(0, 8))
        # "ok" only where the flip hit bits that decode ignores
        assert _try(mutated.tobytes()) in ("error", "ok"), pos


def test_appended_garbage_single_decompress(blob):
    assert api.decompress(blob + b"garbage-tail", device="cpu") == DATA


def test_extreme_header_values():
    head = struct.pack("<4sBBBBQII", b"MHTC", 1, 1, 0, 0,
                       1 << 62, 65536, 1 << 30)
    with pytest.raises(ValueError):
        api.decompress(head, device="cpu")


# ---------------------------------------------------------------------------
# A length index that claims more than the encoder can write. The payload
# size, and so the parse, stay as they were; the decoders must raise before
# they size the expansion by the claim.
# ---------------------------------------------------------------------------

LAYOUTS = {
    # name: (mode, block_size, decode_unit)
    "legacy_u32_bits": ("markov", 1024, 1024),
    "substreams_aligned": ("markov", 4096, 1024),
    "order0_unaligned": ("huffman", 4096, 1024),
}


def _with_unit_lengths(blob_bytes: bytes, byte_lens: np.ndarray) -> bytes:
    """The container with its length index rewritten to `byte_lens`
    (layout bytes per unit, the same sum): the legacy index holds u32 bit
    lengths, the substream index is written in its plain bit-packed
    form (word counts in the aligned layout)."""
    meta = container.parse_container(blob_bytes)
    assert int(byte_lens.sum()) == int(meta.byte_lengths.sum())
    start = meta.payload_off - meta.index_bytes
    head = bytearray(blob_bytes[:start])
    if meta.decode_unit is None:
        index = (byte_lens * 8).astype("<u4").tobytes()
    else:
        aligned = bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD)
        index = jax_container.pack_index(byte_lens // 4 if aligned
                                         else byte_lens)
        head[6] = ((meta.flags | container.FLAG_PACKED_INDEX)
                   & ~(container.FLAG_ENTROPY_INDEX
                       | container.FLAG_GROUPED_INDEX))
    bad = bytes(head) + index + blob_bytes[meta.payload_off:]
    assert np.array_equal(container.parse_container(bad).byte_lengths,
                          byte_lens)
    return bad


def _unit_zero_claims_payload(blob_bytes: bytes) -> bytes:
    meta = container.parse_container(blob_bytes)
    lens = np.zeros_like(meta.byte_lengths)
    lens[0] = meta.byte_lengths.sum()
    return _with_unit_lengths(blob_bytes, lens)


@pytest.fixture(scope="module", params=list(LAYOUTS))
def claimed(request):
    mode, block_size, du = LAYOUTS[request.param]
    good = api.compress(DATA, mode=mode, block_size=block_size,
                        decode_unit=du, device="cpu")
    assert api.decompress(good, device="cpu") == DATA
    return _unit_zero_claims_payload(good)


@pytest.fixture
def no_expansion(monkeypatch):
    """The error must come before the expansion buffer is sized."""
    def fail(*args, **kwargs):
        raise AssertionError("the expansion was called")
    monkeypatch.setattr(bitpack, "device_expand_words", fail)
    monkeypatch.setattr(bitpack, "device_expand_words_u32", fail)


def test_unit_claiming_the_payload_raises_in_decompress(claimed,
                                                        no_expansion):
    with pytest.raises(ValueError, match="unit length"):
        api.decompress(claimed, device="cpu")


def _parsed_result(blob_bytes: bytes) -> engine.EncodeResult:
    """The EncodeResult api.decompress hands engine.decode, all units in
    one chunk."""
    meta = container.parse_container(blob_bytes)
    aligned = bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD)
    payload = torch.from_numpy(np.frombuffer(
        blob_bytes, np.uint8, count=int(meta.byte_lengths.sum()),
        offset=meta.payload_off).copy())
    return engine.EncodeResult(
        mode=get_model(meta.mode).name, block_size=meta.block_size,
        decode_unit=meta.decode_unit or meta.block_size,
        orig_len=meta.orig_len, n_units=len(meta.byte_lengths),
        lengths=meta.lengths, byte_lens=meta.byte_lengths, bit_lens=None,
        payload=bitpack.be_bytes_to_words(payload) if aligned else payload,
        raw_units=bool(meta.flags & container.FLAG_RAW_UNITS),
        aligned=aligned)


def test_unit_claiming_the_payload_raises_in_engine_decode(claimed,
                                                           no_expansion):
    with pytest.raises(ValueError, match="unit length"):
        engine.decode(_parsed_result(claimed))


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0],
                         ids=["device_half", "both", "host_half"])
def test_unit_claiming_the_payload_raises_in_hybrid(claimed, no_expansion,
                                                    monkeypatch, frac):
    def fail(*args, **kwargs):
        raise AssertionError("the host decode was called")
    monkeypatch.setattr(native, "decode_units", fail)
    with pytest.raises(ValueError, match="unit length"):
        hybrid.decompress(claimed, host_fraction=frac, device="cpu")


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_unit_at_the_encoders_longest_stream_still_decodes(mode):
    """All-15-bit codes and decode_unit == block_size (no literal units):
    every full unit's stream is the longest the encoder writes, du * 15
    bits — in the unaligned layout exactly the limit, ceil(du * 15 / 8)
    bytes — and the container decodes; one byte (one word) past the
    limit raises."""
    du = 512
    markov = mode == "markov"
    lengths = np.full((256, 256) if markov else (256,), 15, np.uint8)
    data = np.random.default_rng(5).integers(
        0, 256, 5 * du + 77, dtype=np.uint8).tobytes()
    st = engine.stage(data, mode=mode, block_size=du, decode_unit=du,
                      device="cpu")
    enc = engine.encode(st, lengths=lengths)
    assert int(enc.bit_lens.max()) == du * 15
    limit = (bitpack.words_for_block(du) * 4 if markov
             else -(-du * 15 // 8))
    assert int(enc.byte_lens.max()) == (limit - 4 if markov else limit)
    assert engine.fetch_bytes(enc, engine.decode(enc)) == data
    blob_bytes = engine.assemble_container(enc, None)
    assert api.decompress(blob_bytes, device="cpu") == data
    at_limit = np.array([limit, limit])
    engine.check_unit_lengths(at_limit, du, markov, 2 * du)
    with pytest.raises(ValueError, match="unit length"):
        engine.check_unit_lengths(at_limit + (4 if markov else 1), du,
                                  markov, 2 * du)


# ---------------------------------------------------------------------------
# Crafted containers (chip_smoke.crafted_containers): over-full code
# lengths (a Kraft sum above one, which would make the native table
# builders write past their 2**15-entry tables), and an index bounded
# only from above.
# ---------------------------------------------------------------------------

# Walks every route of the port with one crafted container, in a process
# of its own: a decoder that aborts fails the test, not a test worker.
_EVERY_ROUTE = r"""
import json, sys, threading, urllib.error, urllib.request
sys.path.insert(0, sys.argv[1])
import chip_smoke
from mhc_tpu_torch import api, container, hybrid, serve

clean = chip_smoke.craft_source(sys.argv[3])
bad = chip_smoke.crafted_containers()[sys.argv[2]][0]
errors = {}
for route, fn in (
        ("parse_container", container.parse_container),
        ("api", lambda b: api.decompress(b, device="cpu")),
        ("hybrid", lambda b: hybrid.decompress(b, host_fraction=1.0,
                                               device="cpu"))):
    try:
        fn(bad)
        errors[route] = None
    except ValueError as e:
        errors[route] = str(e)
srv = serve.make_server("127.0.0.1", 0, device="cpu")
t = threading.Thread(target=srv.serve_forever, daemon=True)
t.start()
url = f"http://127.0.0.1:{srv.server_port}"

def post(path, body):
    req = urllib.request.Request(url + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()

status, body = post("/decompress", bad)
errors["serve"] = body.decode() if status == 400 else status
status, body = post("/decompress", clean)
with urllib.request.urlopen(url + "/stats", timeout=30) as r:
    stats = json.loads(r.read())
srv.shutdown()
srv.server_close()
t.join(timeout=30)
print(json.dumps({"errors": errors, "clean_status": status,
                  "clean_ok": body == api.decompress(clean, device="cpu"),
                  "stats_errors": stats["errors"],
                  "stats_requests": stats["requests"]}))
"""


@pytest.mark.parametrize("name,mode", [
    ("overfull_code_lengths_markov", "markov"),
    ("overfull_code_lengths_order0", "huffman")], ids=["input_a", "input_b"])
def test_overfull_code_lengths_refused_on_every_route(name, mode):
    """A Markov container whose 16 table code lengths all read 1 (Input A)
    and an order-0 one whose 256 lengths all read 1 (Input B): the parse,
    api.decompress, hybrid.decompress with every unit on the host and a
    served /decompress each refuse it (400), and the server goes on to
    answer a clean request."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _EVERY_ROUTE, repo, name, mode],
                       cwd=repo, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    want = "mhc: corrupt container (code lengths)"
    assert res["errors"] == dict.fromkeys(
        ("parse_container", "api", "hybrid", "serve"), want)
    assert res["clean_status"] == 200 and res["clean_ok"]
    assert res["stats_errors"] == 1 and res["stats_requests"] == 2


@pytest.fixture(scope="module")
def crafted():
    return chip_smoke.crafted_containers()


@pytest.fixture
def no_decode(monkeypatch):
    """The refusal must come before any unit is decoded."""
    def fail(*args, **kwargs):
        raise AssertionError("a decoder was called")
    monkeypatch.setattr(engine, "decode", fail)
    monkeypatch.setattr(native, "decode_units", fail)


@pytest.mark.parametrize("name", ["negative_unit_length", "orig_len_claim",
                                  "short_units", "payload_size_overflow"])
def test_index_outside_the_encoders_range_refused(crafted, no_decode, name):
    """(a) a negative unit length, (b) an orig_len of 128 MB over an index
    of empty units with no payload, and with a payload of one word a unit
    (under the 512 bytes a 4 KB unit's fewest bits take), (c) a payload
    size past 2**63: ValueError from the parse or the index check, before
    any decode and from every route."""
    bad, want = crafted[name]
    for fn in (lambda: api.decompress(bad, device="cpu"),
               lambda: hybrid.decompress(bad, host_fraction=1.0,
                                         device="cpu")):
        with pytest.raises(ValueError, match=want):
            fn()
    if name != "short_units":
        with pytest.raises(ValueError, match=want):
            container.parse_container(bad)


def test_payload_size_overflow_answers_400(crafted):
    """The served /decompress answers a payload size past 2**63 with 400
    (a struct.error escaped the handler before) and counts the error."""
    import urllib.error
    import urllib.request
    from mhc_tpu_torch import serve
    srv = serve.make_server("127.0.0.1", 0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_port}/decompress",
            data=crafted["payload_size_overflow"][0], method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400
        assert b"payload size" in ei.value.read()
        assert srv.stats.errors == 1
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                        "unaligned"])
def test_unit_length_floor(aligned):
    """A unit of m symbols stores 4 * ceil(m / 32) bytes (aligned) or
    ceil(m / 8) at least: at the floor passes, a byte (word) under it
    raises, and so does a negative length; the last unit's floor follows
    its own symbol count."""
    du, orig = 1024, 2 * 1024 + 40
    floor = [128, 128, 8] if aligned else [128, 128, 5]
    engine.check_unit_lengths(np.array(floor), du, aligned, orig)
    step = 4 if aligned else 1
    for i in range(3):
        short = np.array(floor)
        short[i] -= step
        with pytest.raises(ValueError, match="unit length"):
            engine.check_unit_lengths(short, du, aligned, orig)
    with pytest.raises(ValueError, match="unit length"):
        engine.check_unit_lengths(np.array([-4, 260, 8]), du, aligned, orig)


def test_code_length_check():
    """Complete and incomplete prefix codes pass (a one-symbol row has
    length 1); an over-full row or a length over 15 raises, from the
    check and from both native table builders."""
    ok = np.zeros((3, 256), np.uint8)
    ok[0, :2] = 1                       # complete: 1/2 + 1/2
    ok[1, 7] = 1                        # one symbol
    ok[2, :] = 15                       # 256 / 2**15
    native.check_code_lengths(ok)
    native.check_code_lengths(np.zeros(16, np.uint8))
    over = ok.copy()
    over[0, 2] = 15                     # 1/2 + 1/2 + 2**-15
    long = ok.copy()
    long[1, 8] = 16
    for bad in (over, long):
        with pytest.raises(ValueError, match="code lengths"):
            native.check_code_lengths(bad)
        with pytest.raises(ValueError, match="code lengths"):
            native.build_dec_lut(bad)
    with pytest.raises(ValueError, match="code lengths"):
        native.entropy_decode(b"\x00" * 8, np.ones(16, np.uint8), 4)


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_encoder_tables_pass_the_code_length_check(mode):
    """Every table the encoders write on the test corpora passes the
    check, the packed table section's and the entropy index's code
    lengths included (entropy_decode checks those as it parses)."""
    corpora = {"english_like": english_like(40_000, seed=3),
               "mixed_binary": mixed_binary(40_000, seed=4),
               **{k: v for k, v in ADVERSARIAL.items() if v}}
    for data in corpora.values():
        blob = api.compress(data, mode=mode, block_size=4096,
                            decode_unit=1024, device="cpu")
        native.check_code_lengths(container.parse_container(blob).lengths)
