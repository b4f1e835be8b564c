"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. This file imports
torch, mhc_tpu_torch and chip_smoke (which imports no JAX) only, so it
also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import collections
import hashlib
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
import mhc_tpu_torch
from mhc_tpu_torch import api, engine, hybrid, serve
from mhc_tpu_torch.bench import loop_calib, mosaic_probe, probes, vpu_probe
from mhc_tpu_torch.models.entropy import get_model
from mhc_tpu_torch import container
from mhc_tpu_torch.ops import bitpack, canonical
from mhc_tpu_torch.ops import huffman
from mhc_tpu_torch.ops.kernels import (_build, decode_cuda, encode_cuda,
                                       histogram_cuda, huffman_cuda,
                                       probes_cuda, stages_cuda, tables_cuda)
from mhc_tpu_torch.parallel import pipeline
from mhc_tpu_torch.utils import corpus

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _data(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"etaoin shrdlu.\n", np.uint8), n // 2)
    noise = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([text, noise]).tobytes()


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("n,block,du", [(300_001, 65536, 8192),
                                        (70_000, 8192, 1024),
                                        (5_000, 4096, 4096),
                                        (1_001, 2, 2)])
def test_kernels_equal_plain_versions(dev, mode, n, block, du):
    """Each mode's histogram, K3, K5, K4, K6 and decode kernel against
    its plain version: units with and without literals, and decode units
    that are not multiples of 4 (K7's byte-store path, K5's, K4's and
    K6's scalar paths)."""
    model = get_model(mode)
    hist, hist_plain = ((histogram_cuda.markov_hist,
                         histogram_cuda.markov_hist_plain) if model.markov
                        else (histogram_cuda.order0_hist,
                              histogram_cuda.order0_hist_plain))
    st = engine.stage(_data(n, n), mode=mode, block_size=block,
                      decode_unit=du, device=dev)
    u, nv = st.units, st.n_valid
    counts = hist(u, nv)
    assert torch.equal(counts, hist_plain(u, nv))
    lengths = model.lengths_from_counts(counts.cpu().numpy())
    t = model.tables_from_lengths(lengths, dev)
    fused = encode_cuda.pack_units(u, nv, t["codes"], t["lengths"])
    ref = encode_cuda.pack_units_plain(u, nv, t["codes"], t["lengths"])
    assert all(torch.equal(a, b) for a, b in zip(fused, ref))
    cl = encode_cuda.lookup_cl(u, nv, t["codes"], t["lengths"])
    assert torch.equal(cl, encode_cuda.lookup_cl_plain(u, nv, t["codes"],
                                                       t["lengths"]))
    split = encode_cuda.pack_cl(cl)
    assert all(torch.equal(a, b) for a, b in zip(split, fused))
    assert all(torch.equal(a, b)
               for a, b in zip(split, encode_cuda.pack_cl_plain(cl)))
    bubbles = encode_cuda.bubble_pack(cl)
    assert all(torch.equal(a, b) for a, b in
               zip(bubbles, encode_cuda.bubble_pack_plain(cl)))
    assert torch.equal(bitpack.compact_bubbles(
        *bubbles, bitpack.words_for_block(du)), fused[0])
    enc = engine.encode(st, lengths=lengths)
    words, n_dec, _, t = engine.decode_inputs(enc)
    args = (words, n_dec, t["lim"], t["base"], t["first_code"],
            t["sorted_syms"])
    out = decode_cuda.decode_units(*args, n_out=du, markov=model.markov)
    torch.cuda.synchronize()
    assert torch.equal(out, decode_cuda.decode_units_plain(
        *args, n_out=du, markov=model.markov))
    assert engine.fetch_bytes(enc, engine.decode(enc)) == _data(n, n)


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("n", [1022, 1021])
def test_unaligned_widths_equal_plain_versions(dev, mode, n):
    """Unit widths off the kernels' vector paths (K1 and K2: n % 16, K5
    and K4: n % 4), on raw unit batches with ragged n_valid."""
    model = get_model(mode)
    rng = np.random.default_rng(n)
    u = torch.from_numpy(np.frombuffer(_data(37 * n, n), np.uint8)
                         .reshape(37, n).copy()).to(dev)
    nv = torch.from_numpy(
        rng.integers(0, n + 1, 37).astype(np.int32)).to(dev)
    assert torch.equal(histogram_cuda.markov_hist(u, nv),
                       histogram_cuda.markov_hist_plain(u, nv))
    assert torch.equal(histogram_cuda.order0_hist(u, nv),
                       histogram_cuda.order0_hist_plain(u, nv))
    counts = model.histogram(u, nv).cpu().numpy()
    t = model.tables_from_lengths(model.lengths_from_counts(counts), dev)
    cl = encode_cuda.lookup_cl(u, nv, t["codes"], t["lengths"])
    assert torch.equal(cl, encode_cuda.lookup_cl_plain(u, nv, t["codes"],
                                                       t["lengths"]))
    got = encode_cuda.pack_cl(cl)
    for a, b, c in zip(got, encode_cuda.pack_cl_plain(cl),
                       encode_cuda.pack_units(u, nv, t["codes"],
                                              t["lengths"])):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(encode_cuda.bubble_pack(cl),
                    encode_cuda.bubble_pack_plain(cl)):
        assert torch.equal(a, b)


def _assert_histograms_equal_plain(u, nv):
    for kern, plain in ((histogram_cuda.markov_hist,
                         histogram_cuda.markov_hist_plain),
                        (histogram_cuda.order0_hist,
                         histogram_cuda.order0_hist_plain)):
        got = kern(u, nv)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(u, nv))


@pytest.mark.parametrize("pattern", ["zeros", "001", "ff", "counters"])
def test_histograms_count_past_16_bits(dev, pattern):
    """40 rows of 8 KB per SM, so that each of K1's blocks counts more
    than 2^16 of one pair in its 16-bit fields: zeros (pair (0, 0), the
    low half of word 0), [0, 0, 1] repeated ((0, 0) and (0, 1) share a
    word: both halves wrap), 0xFF (the high half of the last word), and
    the corpus's little-endian u32 counters."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    R, n = 40 * sms, 8192
    if pattern == "counters":
        flat = torch.from_numpy(np.arange(0x7F0000, 0x7F0000 + R * n // 4,
                                          dtype="<u4").view(np.uint8))
    else:
        unit = {"zeros": [0], "001": [0, 0, 1], "ff": [255]}[pattern]
        flat = torch.tensor(unit, dtype=torch.uint8).repeat(R * n)[:R * n]
    u = flat.to(dev).view(R, n)
    nv = torch.full((R,), n, dtype=torch.int32, device=dev)
    _assert_histograms_equal_plain(u, nv)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [4096, 1021])
def test_histograms_on_offset_views_and_short_units(dev, offset, n):
    """K1 and K2 on a units view `offset` bytes into a larger buffer (a
    1-byte offset takes the scalar path, as n = 1021 does), with n_valid
    of 0, 1, 15, 16, 17 and ragged; the flat shares of the grid split
    units wherever they fall."""
    R = 300
    rng = np.random.default_rng(n + offset)
    buf = torch.from_numpy(np.frombuffer(_data(R * n + offset, n),
                                         np.uint8).copy()).to(dev)
    u = buf[offset:].view(R, n)
    nv = rng.integers(0, n + 1, R).astype(np.int32)
    nv[:6] = [0, 1, 15, 16, 17, n]
    _assert_histograms_equal_plain(u, torch.from_numpy(nv).to(dev))


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("data", [b"", b"Q", b"QQ", bytes(4096),
                                  bytes(range(256)) * 16, b"xy" * 65536,
                                  _data(100_003, 7)],
                         ids=["empty", "1", "2", "zeros", "ramp", "xy",
                              "mixed"])
def test_gpu_container_equals_cpu_container(dev, mode, data):
    blob = mhc_tpu_torch.compress(data, mode=mode, device=dev)
    assert blob == mhc_tpu_torch.compress(data, mode=mode, device="cpu")
    for pack_method in ("dense", "pallas"):
        assert blob == mhc_tpu_torch.compress(data, mode=mode, device=dev,
                                              pack_method=pack_method)
    assert mhc_tpu_torch.decompress(blob, device=dev) == data


_DEC = {"decode_lut": 1, "decode_units": 1}
_DEC0 = {"decode_lut_order0": 1, "decode_units_order0": 1}


@pytest.mark.parametrize("mode,pack_method,expected", [
    ("markov", "fused", {"markov_hist": 1, "pack_units": 1, **_DEC}),
    ("markov", "dense", {"markov_hist": 1, "lookup_cl": 1, "pack_cl": 1,
                         **_DEC}),
    ("huffman", "fused", {"order0_hist": 1, "pack_units": 1, **_DEC0}),
    ("markov", "pallas", {"markov_hist": 1, "lookup_cl": 1,
                          "bubble_pack": 1, "compact_bubbles": 1, **_DEC}),
    ("huffman", "dense", {"order0_hist": 1, "lookup_cl": 1, "pack_cl": 1,
                          **_DEC0}),
    ("huffman", "pallas", {"order0_hist": 1, "lookup_cl": 1,
                           "bubble_pack": 1, "compact_bubbles": 1,
                           **_DEC0})])
def test_launch_counters_count_kernel_launches(dev, mode, pack_method,
                                               expected):
    """The default table build on a card is the fused one (K11 and K13
    in one launch): once per encode, K11 and K13 alone never; K13 once
    on the decode, K15 once on a "pallas" encode, K10+K8 once, K9 once,
    and K14 once where a literal row exists."""
    st = engine.stage(_data(50_000, 1), mode=mode, device=dev)
    _build.LAUNCHES.clear()
    enc = engine.encode(st, pack_method=pack_method)
    engine.decode(enc)
    lit = bitpack.raw_unit_mask(enc.byte_lens, engine.host_n_valid(
        enc.orig_len, enc.decode_unit, enc.n_units), enc.aligned).any()
    assert dict(_build.LAUNCHES) == {
        **expected, "code_tables": 1, "canonical_tables": 1,
        "compact_units": 1, "expand_units": 1,
        **({"literal_rows": 1} if lit else {})}


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_chunked_api_and_hybrid_on_the_card(dev, monkeypatch, mode):
    """Several chunks through the side-stream copies, and the hybrid
    split, write the CPU's container and read it back."""
    data = _data(300_001, 3)
    ref = mhc_tpu_torch.compress(data, mode=mode, device="cpu")
    monkeypatch.setattr(api, "CHUNK_BYTES", 40_000)
    for pack_method in ("fused", "pallas"):
        assert api.compress(data, mode=mode, device=dev,
                            pack_method=pack_method) == ref
    assert api.decompress(ref, device=dev) == data
    for frac in (0.0, 0.5):
        assert hybrid.compress(data, mode=mode, host_fraction=frac,
                               device=dev) == ref
        assert hybrid.decompress(ref, host_fraction=frac,
                                 device=dev) == data


def _edge_lengths(kind: str, markov: bool, seed: int) -> np.ndarray:
    """Code lengths of every symbol: "all15" (every code 15 bits: every
    Markov window escapes) or "skewed" (zipf counts, long codes in
    play)."""
    shape = (256, 256) if markov else (256,)
    if kind == "all15":
        return np.full(shape, 15, np.uint8)
    rng = np.random.default_rng(seed)
    counts = rng.zipf(1.4, shape).astype(np.int64)
    model = get_model("markov" if markov else "huffman")
    return model.lengths_from_counts(np.minimum(counts, 1 << 30))


# Unit counts around K7's layout switch (`decode_cuda.layout`) on a card
# of S SMs: at most 128 threads a block up to S * 128 units, more past it;
# the last, past two rounds of 512 threads a block, ends in a partial one.
_K7_SWITCH = {"S*128-1": lambda s: s * 128 - 1, "S*128": lambda s: s * 128,
              "S*128+1": lambda s: s * 128 + 1,
              "2*S*512+S*100+7": lambda s: 2 * s * 512 + s * 100 + 7}


def _k7_units(R, dev) -> int:
    return _K7_SWITCH[R](_build.sm_count(dev)) if isinstance(R, str) else R


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("kind", ["skewed", "all15"])
@pytest.mark.parametrize("R,n", [(1, 8192), (7, 8192), (133, 512),
                                 (300, 16384), (45, 1024), (5, 1000),
                                 *((r, n) for r in _K7_SWITCH
                                   for n in (512, 1000))])
def test_k3_and_k7_edges_equal_plain_versions(dev, mode, kind, R, n):
    """K3 (a warp per unit, lane chunks) and K7 (table-driven) at the
    edges: n_valid of 0, 1, 31, 33, 257 and a last unit cut short; one
    unit; R not a multiple of a block or of the warps of the grid; widths
    off the 16-byte paths; all-15-bit codes; R on both sides of K7's
    layout switch and past two rounds of its largest layout, with the
    launch in `decode_cuda.layout`'s shape."""
    markov = mode == "markov"
    R = _k7_units(R, dev)
    rng = np.random.default_rng(R * n)
    lengths = _edge_lengths(kind, markov, R + n)
    model = get_model(mode)
    t = model.tables_from_lengths(lengths, dev)
    # both length sets code every symbol in every context
    units = torch.from_numpy(
        rng.integers(0, 256, (R, n), dtype=np.uint8)).to(dev)
    nv = np.full(R, n, np.int32)
    edges = [0, 1, 31, 33, 257, n - 5]
    nv[: min(R, len(edges))] = [min(e, n) for e in edges][:R]
    nv[-1] = min(nv[-1], n // 3 + 1)
    nv = torch.from_numpy(nv).to(dev)
    got = encode_cuda.pack_units(units, nv, t["codes"], t["lengths"])
    torch.cuda.synchronize()
    ref = encode_cuda.pack_units_plain(units, nv, t["codes"], t["lengths"])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    words = got[0]
    args = (nv, t["lim"], t["base"], t["first_code"], t["sorted_syms"])
    decode_cuda.LAYOUTS.clear()
    out = decode_cuda.decode_units(words, *args, n_out=n, markov=markov)
    torch.cuda.synchronize()
    assert dict(decode_cuda.LAYOUTS) == {
        decode_cuda.layout(R, _build.sm_count(dev), markov)[1]: 1}
    assert torch.equal(out, decode_cuda.decode_units_plain(
        words, *args, n_out=n, markov=markov))
    valid = torch.arange(n, device=dev)[None, :] < nv[:, None]
    assert torch.equal(out[valid], units[valid])


@pytest.mark.parametrize("R", ["S*128-1", "S*128+1", "2*S*512+S*100+7"])
def test_engine_round_trip_across_k7_layouts(dev, R):
    """engine.encode -> engine.decode on 512-byte units below K7m's
    layout switch (at most 128 threads a block), just past it, and past
    two rounds of 512 threads a block; `decode_cuda.LAYOUTS` shows the
    launch's threads a block."""
    R = _k7_units(R, dev)
    data = _data(R * 512 - 37, R)
    st = engine.stage(data, decode_unit=512, device=dev)
    assert st.n_units == R
    enc = engine.encode(st)
    decode_cuda.LAYOUTS.clear()
    out = engine.decode(enc)
    threads = decode_cuda.layout(R, _build.sm_count(dev))[1]
    assert dict(decode_cuda.LAYOUTS) == {threads: 1}
    assert (threads > 128) == (R > 128 * _build.sm_count(dev))
    assert engine.fetch_bytes(enc, out) == data


def _tile_case(dev, kind: str, R: int, n: int):
    """Random units under `kind` Markov tables, rows of n_valid 0 between
    full rows and a last unit cut short: (units, n_valid, codes,
    lengths, cl plane)."""
    rng = np.random.default_rng(R * n + 1)
    t = get_model("markov").tables_from_lengths(
        _edge_lengths(kind, True, R + n), dev)
    units = torch.from_numpy(
        rng.integers(0, 256, (R, n), dtype=np.uint8)).to(dev)
    nv = np.full(R, n, np.int32)
    nv[1::3] = 0
    if R > 1:
        nv[-1] = n // 3 + 1
    nv = torch.from_numpy(nv).to(dev)
    cl = encode_cuda.lookup_cl(units, nv, t["codes"], t["lengths"])
    return units, nv, t["codes"], t["lengths"], cl


def _assert_tile_packers(cl, k3):
    """K4 and K6 on `cl` equal their plain versions, and K4 and the
    compacted K6 equal K3's (words, bits)."""
    k4 = encode_cuda.pack_cl(cl)
    k6 = encode_cuda.bubble_pack(cl)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b)
               for a, b in zip(k4, encode_cuda.pack_cl_plain(cl)))
    assert all(torch.equal(a, b) for a, b in zip(k4, k3))
    assert k6[0].is_contiguous() and k6[1].is_contiguous()
    assert all(torch.equal(a, b)
               for a, b in zip(k6, encode_cuda.bubble_pack_plain(cl)))
    assert torch.equal(bitpack.compact_bubbles(*k6, k3[0].shape[1]), k3[0])
    assert torch.equal(k6[3], k3[1])


@pytest.mark.parametrize("kind", ["skewed", "all15"])
@pytest.mark.parametrize("n", [4, 12, 510, 8192, 65536])
@pytest.mark.parametrize("R", [1, 31, 33, 257])
def test_k4_and_k6_tiles_equal_plain_versions_and_k3(dev, kind, R, n):
    """The tile packer (a warp per unit, 128 symbols per tile) at its
    edges: one unit, R off the block's 4 warps, n below a tile, off the
    16-byte path (510), 64 and 512 tiles; rows of zeros between full
    rows; all-15-bit codes (a word completes almost every second code)."""
    units, nv, codes, lengths, cl = _tile_case(dev, kind, R, n)
    _assert_tile_packers(cl, encode_cuda.pack_units(units, nv, codes,
                                                    lengths))


@pytest.mark.parametrize("kind", ["skewed", "all15"])
@pytest.mark.parametrize("n", [12, 8192])
def test_k4_and_k6_on_a_4_byte_offset_view(dev, kind, n):
    """A cl plane 4 bytes into its buffer is off the 16-byte copies:
    the scalar path."""
    units, nv, codes, lengths, cl = _tile_case(dev, kind, 33, n)
    buf = torch.empty(cl.numel() + 1, dtype=torch.int32, device=dev)
    view = buf[1:].view(cl.shape)
    view.copy_(cl)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    _assert_tile_packers(view, encode_cuda.pack_units(units, nv, codes,
                                                      lengths))


def test_k4_drops_words_past_a_narrow_row(dev):
    """The C contract: writes at index >= W are dropped, row by row."""
    _, _, _, _, cl = _tile_case(dev, "all15", 5, 1024)
    ref, ref_bits = encode_cuda.pack_cl_plain(cl)
    lib, fn = _build.load("encode", "mhc_pack_cl",
                          encode_cuda._PACK_CL_ARGTYPES)
    for W in (100, 1):
        words = torch.zeros((5, W), dtype=torch.int32, device=dev)
        bits = torch.empty((5,), dtype=torch.int32, device=dev)
        rc = fn(cl.data_ptr(), 5, 1024, words.data_ptr(), W,
                bits.data_ptr(), _build.stream_ptr(dev))
        _build.check(lib, rc, "pack_cl")
        torch.cuda.synchronize()
        assert torch.equal(words, ref[:, :W]) and torch.equal(bits, ref_bits)


def test_k4_and_k6_reject_units_past_32_bit_offsets(dev):
    """n * 15 must stay below 2^31, as for K3."""
    n = (1 << 31) // 15 + 1
    dummy = torch.zeros(16, dtype=torch.int32, device=dev)
    lib, fn = _build.load("encode", "mhc_pack_cl",
                          encode_cuda._PACK_CL_ARGTYPES)
    assert fn(dummy.data_ptr(), 1, n, dummy.data_ptr(), 1, dummy.data_ptr(),
              _build.stream_ptr(dev)) != 0
    lib, fn = _build.load("encode", "mhc_bubble_pack",
                          encode_cuda._BUBBLE_ARGTYPES)
    assert fn(dummy.data_ptr(), 1, n, dummy.data_ptr(), dummy.data_ptr(),
              dummy.data_ptr(), dummy.data_ptr(),
              _build.stream_ptr(dev)) != 0


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("kind", ["skewed", "all15"])
def test_decode_lut_equals_plain_version(dev, mode, kind):
    markov = mode == "markov"
    t = get_model(mode).tables_from_lengths(_edge_lengths(kind, markov, 3),
                                            dev)
    args = (t["lim"], t["base"], t["first_code"], t["sorted_syms"])
    _build.LAUNCHES.clear()
    lut = decode_cuda.decode_lut(*args, markov=markov)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_lut" if markov
                           else "decode_lut_order0"] == 1
    assert torch.equal(lut, decode_cuda.decode_lut_plain(*args,
                                                         markov=markov))


def test_failed_build_raises_instead_of_falling_back(dev, monkeypatch):
    def broken(name):
        raise RuntimeError(f"nvcc failed to build {name}")
    monkeypatch.setattr(_build, "build", broken)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(histogram_cuda, "markov_hist_plain", None)
    u = torch.zeros((2, 16), dtype=torch.uint8, device=dev)
    nv = torch.full((2,), 16, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        histogram_cuda.markov_hist(u, nv)


def _k11_rows(kind: str) -> np.ndarray:
    """(rows, 256) int64 counts of K11's corners: the degenerate rows,
    ties, the 15-bit repair, int64 totals."""
    rng = np.random.default_rng(len(kind))
    fib = np.zeros(256, np.int64)
    a, b = 1, 1
    for i in range(256):
        fib[i], (a, b) = a, (b, min(a + b, 1 << 40))
    one, two = np.zeros((1, 256), np.int64), np.zeros((1, 256), np.int64)
    one[0, 42] = 999
    two[0, 1], two[0, 200] = 7, 1
    big = rng.integers(1 << 23, 1 << 24, 256).astype(np.int64)
    return {
        "all_zero": np.zeros((3, 256), np.int64), "one_symbol": one,
        "two_symbols": two, "all_equal": np.full((2, 256), 5, np.int64),
        "fibonacci": np.stack([fib, rng.permutation(fib),
                               np.where(np.arange(256) < 40, fib, 0)]),
        "over_2_31": np.stack([big, big << 8, big << 30]),
        "random": (rng.integers(0, 10 ** 6, (300, 256))
                   * (rng.random((300, 256)) < rng.random((300, 1)))),
        # 256 seeded rows of 2..256 symbols, weights over 1..7 decades
        "random_256": np.concatenate([
            r.integers(1, 10 ** int(r.integers(1, 8)), (64, 256))
            * (r.random((64, 256)) < r.random((64, 1)))
            for r in map(np.random.default_rng, range(10, 14))]),
        "three_symbols": np.stack([_three(5, 5, 5), _three(1, 2, 3),
                                   _three(1, 1, 1 << 20)]),
    }[kind]


def _three(*weights) -> np.ndarray:
    c = np.zeros(256, np.int64)
    c[[3, 100, 255]] = weights
    return c


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("kind", ["all_zero", "one_symbol", "two_symbols",
                                  "three_symbols", "all_equal", "fibonacci",
                                  "over_2_31", "random", "random_256"])
def test_k11_equals_plain_version_and_host_build(dev, kind, dtype):
    counts = _k11_rows(kind)
    if dtype == torch.int32:
        counts = np.minimum(counts, 1 << 22)   # a row's total fits int32
    t = torch.from_numpy(counts).to(dev, dtype)
    _build.LAUNCHES.clear()
    got = huffman_cuda.code_lengths(t)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["code_lengths"] == 1
    assert torch.equal(got, huffman_cuda.code_lengths_plain(t))
    host = get_model("markov").lengths_from_counts(counts)
    assert (got.cpu().numpy() == host).all()


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_k11_on_corpus_counts_and_both_table_builds(dev, mode):
    """K11 on a histogram's counts, in place on the card, equals the host
    build; the engine's two table builds write the same container, the
    fused build (K11 and K13 in one launch) launched by the device build
    only, and K11 alone by neither."""
    model = get_model(mode)
    data = _data(300_001, 5)
    st = engine.stage(data, mode=mode, device=dev)
    counts = model.histogram(st.units, st.n_valid)
    lengths = huffman.code_lengths(counts)
    assert lengths.shape == counts.shape and lengths.device == counts.device
    assert (lengths.cpu().numpy()
            == model.lengths_from_counts(counts.cpu().numpy())).all()
    blobs = {}
    host_lengths = model.lengths_from_counts(engine.histogram(st))
    for build, encode in (
            ("device", lambda: engine.encode(st)),
            ("host", lambda: engine.encode(st, lengths=host_lengths))):
        _build.LAUNCHES.clear()
        enc = encode()
        assert _build.LAUNCHES["code_tables"] == (build == "device")
        assert _build.LAUNCHES["canonical_tables"] == (build == "host")
        assert _build.LAUNCHES["code_lengths"] == 0
        blobs[build] = engine.assemble_container(enc, None)
    assert blobs["device"] == blobs["host"]
    _build.LAUNCHES.clear()
    assert (api.compress(data, mode=mode, device=dev)
            == mhc_tpu_torch.compress(data, mode=mode, device="cpu"))
    assert _build.LAUNCHES["code_tables"] == 1
    assert _build.LAUNCHES["code_lengths"] == 0
    assert _build.LAUNCHES["canonical_tables"] == 0


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_sharded_world_of_one_on_the_card(dev, mode):
    data = _data(300_001, 6)
    blob = pipeline.compress_sharded(data, mode=mode, device=dev)
    assert blob == mhc_tpu_torch.compress(data, mode=mode, device="cpu")
    assert pipeline.decompress_sharded(blob, device=dev) == data


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_staged_world_of_one_on_the_card(dev, mode):
    """`encode_staged` of a share staged on the card, in a world of one:
    the engine's payload, and through the gathers `api.compress`'s
    container and the input back."""
    data = _data(300_001, 7)
    st = engine.stage(data, mode=mode, device=dev)
    enc = pipeline.encode_staged(st)
    assert enc.payload.device == st.units.device
    assert torch.equal(enc.payload, engine.encode(st).payload)
    assert (pipeline.gather_container(enc, zlib.crc32(data) & 0xFFFFFFFF)
            == mhc_tpu_torch.compress(data, mode=mode, device="cpu"))
    assert pipeline.gather_bytes(enc, engine.decode(enc)) == data


def test_native_plans_on_the_card(dev):
    """An engine round trip on the card plans its units in the host
    library both ways, in both modes, and writes the container and the
    bytes of the CPU route."""
    data = _data(300_001, 22)
    crc = zlib.crc32(data) & 0xFFFFFFFF
    for mode in ("markov", "huffman"):
        st = engine.stage(data, mode=mode, device=dev)
        enc = engine.encode(st)
        out = engine.fetch_bytes(enc, engine.decode(enc))
        assert (engine.assemble_container(enc, crc), out) == (
            mhc_tpu_torch.compress(data, mode=mode, device="cpu"), data)


# ---------------------------------------------------------------------------
# K13, K10+K8, K9/K12 and K14: the engine's stage kernels (csrc/tables.cu,
# csrc/stages.cu)
# ---------------------------------------------------------------------------

def _stage_units(R: int, du: int, seed: int):
    """(R, du) units zero past n_valid, n_valid with 0 rows and a ragged
    last unit, and bit counts on both sides of both literal rules."""
    rng = np.random.default_rng(seed)
    nv = np.full(R, du, np.int32)
    nv[rng.choice(R, max(1, R // 8), replace=False)] = 0
    nv[-1] = du // 2 + 1
    u = rng.integers(0, 256, (R, du), dtype=np.uint8)
    u[np.arange(du)[None, :] >= nv[:, None]] = 0
    bits = rng.integers(0, du * 15 + 1, R)
    for i, unit in enumerate((32, 8)):
        rows = np.arange(R) % 4 == i
        bits[rows] = ((-(-nv.astype(np.int64) * 8 // unit)) * unit
                      - rng.integers(0, unit, R))[rows]
    bits[rng.choice(R, max(1, R // 8), replace=False)] = 0
    return u, nv, np.maximum(bits, 0).astype(np.int32)


def _compact_args(dev, words, u, nv, bits, aligned: bool):
    """The host plan `engine.compact` makes, on the card."""
    raw = bitpack.literal_unit_mask(bits, nv, aligned)
    wl = (np.where(raw, nv.astype(np.int64) * 8, bits) + 31) // 32
    offs = np.concatenate([[0], np.cumsum(wl)])
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (d(words), d(u), d(nv), d(offs), d(raw), int(offs[-1])), raw


def _equal(a, b) -> bool:
    torch.cuda.synchronize()
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("R,du", [(1, 64), (37, 64), (300, 1024),
                                  (64, 8192)])
def test_compact_units_equals_plain_version(dev, aligned, R, du):
    u, nv, bits = _stage_units(R, du, R + du)
    W = bitpack.words_for_block(du)
    words = np.random.default_rng(R).integers(
        -(1 << 31), 1 << 31, (R, W), dtype=np.int64).astype(np.int32)
    args, raw = _compact_args(dev, words, u, nv, bits, aligned)
    got = stages_cuda.compact_units(*args)
    assert _equal(got, bitpack.compact_units_plain(*args))
    # rows of a wider plane (compact_bubbles' view), and a literal plan
    wide = torch.nn.functional.pad(args[0], (0, 3))[:, :W]
    assert _equal(stages_cuda.compact_units(wide, *args[1:]), got)


@pytest.mark.parametrize("R,max_len", [(1, 5), (37, 40), (300, 2049),
                                       (3, 0)])
def test_expand_units_equals_plain_version(dev, R, max_len):
    """K9 on words and K12 on bytes at offsets off a multiple of 4, empty
    units, W above the longest unit."""
    rng = np.random.default_rng(R)
    for dtype, scale in ((np.int32, 1), (np.uint8, 4)):
        lens = rng.integers(0, max_len * scale + 1, R).astype(np.int64)
        lens[rng.choice(R, max(1, R // 5), replace=False)] = 0
        offs = np.concatenate([[0], np.cumsum(lens)])
        info = np.iinfo(dtype)
        payload = torch.from_numpy(rng.integers(
            info.min, int(info.max) + 1, int(offs[-1]),
            dtype=np.int64).astype(dtype)).to(dev)
        offs_d = torch.from_numpy(offs).to(dev)
        W = int(-(-lens.max() // scale)) + 1
        got = stages_cuda.expand_units(payload, offs_d, W)
        assert _equal(got, bitpack.expand_units_plain(payload, offs_d, W))


@pytest.mark.parametrize("R,du,W", [(9, 64, 32), (9, 64, 11),
                                    (300, 8192, 2049), (5, 16384, 4097),
                                    (4, 4, 1)])
def test_literal_rows_equals_plain_version(dev, R, du, W):
    rng = np.random.default_rng(du + W)
    words = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (R, W), dtype=np.int64).astype(np.int32)).to(dev)
    out = torch.from_numpy(rng.integers(0, 256, (R, du),
                                        dtype=np.uint8)).to(dev)
    rows = torch.from_numpy(np.flatnonzero(rng.random(R) < 0.4)).to(dev)
    got = stages_cuda.literal_rows(out.clone(), words, rows)
    assert _equal(got, bitpack.literal_rows_plain(out.clone(), words, rows))


@pytest.mark.parametrize("kind", ["markov", "order0", "absent", "one_symbol",
                                  "all15", "any_uint8"])
def test_canonical_tables_equal_plain_version(dev, kind):
    """K13 on valid codes, all-absent and one-symbol rows, all 15, and
    any uint8 (lengths past 15 sort as the plain version's key puts
    them; lim clamped to 2^31 - 1)."""
    rng = np.random.default_rng(len(kind))
    lengths = {
        "markov": lambda: _edge_lengths("skewed", True, 1),
        "order0": lambda: _edge_lengths("skewed", False, 2)[None],
        "absent": lambda: np.zeros((1, 256), np.uint8),
        "one_symbol": lambda: np.eye(1, 256, 200, dtype=np.uint8),
        "all15": lambda: _edge_lengths("all15", True, 0),
        "any_uint8": lambda: rng.integers(0, 256, (256, 256),
                                          dtype=np.uint8),
    }[kind]()
    lengths = torch.from_numpy(np.ascontiguousarray(lengths)).to(dev)
    got = tables_cuda.canonical_tables(lengths, 256)
    ref = canonical.canonical_tables_plain(lengths, 256)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].is_contiguous() and _equal(got[k], ref[k]), k


@pytest.mark.parametrize("mode", ["markov", "order0"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("kind", ["all_zero", "one_symbol", "two_symbols",
                                  "three_symbols", "all_equal", "fibonacci",
                                  "over_2_31", "random", "random_256"])
def test_code_tables_equal_plain_version(dev, kind, dtype, mode):
    """The fused table build (K11 then K13's body in the same blocks) ==
    its plain version (K11's, then K13's): Markov, every row of counts
    its row of tables; order-0, each row of counts alone, its tables on
    all 256 rows (256 blocks building the same row)."""
    counts = _k11_rows(kind)
    if dtype == torch.int32:
        counts = np.minimum(counts, 1 << 22)   # a row's total fits int32
    t = torch.from_numpy(counts).to(dev, dtype)
    cases = ([(t, t.shape[0])] if mode == "markov"
             else [(t[i: i + 1], 256) for i in range(min(len(t), 4))])
    for c, rows in cases:
        _build.LAUNCHES.clear()
        lengths, tables = huffman_cuda.code_tables(c, rows)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["code_tables"] == 1
        ref_lengths, ref = huffman_cuda.code_tables_plain(c, rows)
        assert _equal(lengths, ref_lengths)
        assert set(tables) == set(ref)
        for k in ref:
            assert tables[k].is_contiguous() and _equal(tables[k], ref[k]), k


def _k15_bubbles(dev, R: int, rounds: int, seed: int):
    """A bubble stream as K6 writes one, at any shape: each unit's valid
    slots at a density of its own (units with none among them), random
    words behind every slot, and bits = 32 * valid slots + a tail of
    0-31 bits (units with and without a tail)."""
    rng = np.random.default_rng(seed)
    bv = (rng.random((R, rounds)) < rng.random((R, 1))).astype(np.uint8)
    bv[rng.random(R) < 0.2] = 0
    bw = rng.integers(-(1 << 31), 1 << 31, (R, rounds),
                      dtype=np.int64).astype(np.int32)
    tail_bits = rng.integers(0, 32, R) * (rng.random(R) < 0.7)
    bv[:2] = 0
    tail_bits[:2] = (0, 17)[:R]    # unit 0 empty, unit 1 a tail alone
    bits = 32 * bv.sum(axis=1, dtype=np.int64) + tail_bits
    tail = rng.integers(-(1 << 31), 1 << 31, R,
                        dtype=np.int64).astype(np.int32)
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (d(bw), d(bv), d(tail), d(bits.astype(np.int32))), bits


@pytest.mark.parametrize("R,rounds", [(1, 1), (3, 5), (37, 1023), (64, 1024),
                                      (19, 1025), (133, 2051), (5, 4096),
                                      (2, 32768), (300, 6)])
def test_k15_equals_plain_versions(dev, R, rounds):
    """K15's two entry points == their plain versions: rounds off the
    4-slot loads and off the 1,024-slot tile, units with no valid slot,
    with and without a tail; the rows at the widest stream's width and
    wider, the payload on the streams' words."""
    bubbles, bits = _k15_bubbles(dev, R, rounds, R * rounds)
    n_words = (bits.astype(np.int64) + 31) // 32
    for W in (int(n_words.max()), int(n_words.max()) + 7):
        _build.LAUNCHES.clear()
        got = stages_cuda.compact_bubbles(*bubbles, W)
        assert _build.LAUNCHES["compact_bubbles"] == (W > 0)
        assert _equal(got, bitpack.compact_bubbles(*bubbles, W))
    total = int(n_words.sum())
    _build.LAUNCHES.clear()
    got = stages_cuda.bubbles_to_payload(*bubbles)
    assert _build.LAUNCHES["bubbles_to_payload"] == 1
    ref = bitpack.bubbles_to_payload(*bubbles)
    assert got.shape == ref.shape
    assert _equal(got[:total], ref[:total])


@pytest.mark.parametrize("n", [1, 7, 333, 8191, 8192])
def test_k15_on_k6_output_equals_plain_versions_and_k3(dev, n):
    """K15 on K6's own output (odd n: a last round of one code), equal to
    the plain versions, and the rows K3's words."""
    units, nv, codes, lengths, cl = _tile_case(dev, "skewed", 33, n)
    bubbles = encode_cuda.bubble_pack(cl)
    W = bitpack.words_for_block(n)
    rows = stages_cuda.compact_bubbles(*bubbles, W)
    assert _equal(rows, bitpack.compact_bubbles(*bubbles, W))
    assert _equal(rows, encode_cuda.pack_units(units, nv, codes, lengths)[0])
    total = int(((bubbles[3].long() + 31) // 32).sum())
    got = stages_cuda.bubbles_to_payload(*bubbles)[:total]
    assert _equal(got, bitpack.bubbles_to_payload(*bubbles)[:total])


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_stage_kernels_on_an_engine_batch(dev, mode):
    """Each stage kernel == its plain version on one engine batch of each
    mode (Markov 8 KB units, order-0 16 KB, literal units in play), and
    K12 on the order-0 container's parsed, unaligned payload."""
    model = get_model(mode)
    data = _data(1 << 20, 12)
    st = engine.stage(data, mode=mode, device=dev)
    t = model.tables_from_lengths(model.lengths_for(
        model.histogram(st.units, st.n_valid)), dev)
    lengths = t["lengths"][:1 if not model.markov else 256].to(torch.uint8)
    ref = canonical.canonical_tables_plain(lengths.contiguous(), 256)
    assert all(_equal(t[k], ref[k]) for k in ref)
    words, bits = encode_cuda.pack_units(st.units, st.n_valid, t["codes"],
                                         t["lengths"])
    aligned = container.aligned_payload(model.mode)
    args, raw = _compact_args(
        dev, words.cpu().numpy(), st.units.cpu().numpy(),
        st.n_valid.cpu().numpy(), bits.cpu().numpy(), aligned)
    assert raw.any()
    payload = stages_cuda.compact_units(*args)
    assert _equal(payload, bitpack.compact_units_plain(*args))
    enc = engine.encode(st)
    assert _equal(enc.payload, payload)
    w, n_dec, raw, _ = engine.decode_inputs(enc)
    lens = (enc.bit_lens + 31) // 32
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])).to(dev)
    assert _equal(w, bitpack.expand_units_plain(enc.payload, offs,
                                                w.shape[1]))
    out = decode_cuda.decode_units(w, n_dec, t["lim"], t["base"],
                                   t["first_code"], t["sorted_syms"],
                                   n_out=enc.decode_unit,
                                   markov=model.markov)
    rows = torch.from_numpy(np.flatnonzero(raw)).to(dev)
    got = stages_cuda.literal_rows(out.clone(), w, rows)
    assert _equal(got, bitpack.literal_rows_plain(out.clone(), w, rows))
    assert engine.fetch_bytes(enc, got) == data
    meta = container.parse_container(engine.assemble_container(enc, None))
    starts = np.concatenate([[0], np.cumsum(meta.byte_lengths)])
    pay = np.frombuffer(engine.fetch_payload(enc), np.uint8)
    parsed = api.parsed_chunk(meta, 0, enc.n_units,
                              torch.from_numpy(pay.copy()).to(dev))
    if not aligned:
        assert parsed.payload.dtype == torch.uint8
        offs = torch.from_numpy(starts.astype(np.int64)).to(dev)
        W = int(-(-meta.byte_lengths.max() // 4)) + 1
        assert _equal(stages_cuda.expand_units(parsed.payload, offs, W),
                      bitpack.expand_units_plain(parsed.payload, offs, W))
    assert engine.fetch_bytes(parsed, engine.decode(parsed)) == data


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_engine_launches_each_stage_kernel(dev, mode):
    """One engine.encode launches its table build once (K13 alone on
    given lengths, the fused build on the device's counts) and K10+K8
    once; one engine.decode K13 and K9 once each, and K14 once, literal
    rows being present (order-0 on noise; Markov with every pair coded in
    8 bits, every unit a literal)."""
    data = _data(300_001, 13)
    st = engine.stage(data, mode=mode, device=dev)
    lengths = (None if mode == "huffman"
               else np.full((256, 256), 8, np.uint8))
    _build.LAUNCHES.clear()
    enc = engine.encode(st, lengths=lengths)
    assert _build.LAUNCHES["canonical_tables"] == (lengths is not None)
    assert _build.LAUNCHES["code_tables"] == (lengths is None)
    assert _build.LAUNCHES["compact_units"] == 1
    _build.LAUNCHES.clear()
    out = engine.decode(enc)
    assert {k: _build.LAUNCHES[k] for k in (
        "canonical_tables", "expand_units", "literal_rows",
        "compact_units")} == {"canonical_tables": 1, "expand_units": 1,
                              "literal_rows": 1, "compact_units": 0}
    assert engine.fetch_bytes(enc, out) == data


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("pack_method", ["fused", "dense", "pallas"])
@pytest.mark.parametrize("du", [None, 65536])
def test_engine_on_the_card_never_calls_a_plain_stage(dev, monkeypatch, mode,
                                                      pack_method, du):
    """Every plain version of the stage kernels (K13, K10+K8, K9/K12,
    K14, K15) and of the table builds (K11, the fused build), and the
    plain helpers they are built from, raise: the engine's encode and
    decode on the card still run (and round-trip), on every route, so its
    path never reaches them. (The container's metadata coder, on the
    host, builds its canonical code with `canonical_codes`: no container
    is built here.)"""
    def boom(*a, **k):
        raise AssertionError("a plain stage ran on the card")
    for mod, names in ((canonical, ("canonical_codes",
                                    "canonical_tables_plain")),
                       (huffman_cuda, ("code_lengths_plain",
                                       "code_tables_plain",
                                       "rescale_plain")),
                       (bitpack, ("substitute_raw_units", "literal_words",
                                  "device_compact_words",
                                  "compact_units_plain",
                                  "device_expand_words_u32",
                                  "device_expand_words",
                                  "expand_units_plain",
                                  "words_to_unit_bytes",
                                  "literal_rows_plain", "compact_bubbles",
                                  "bubbles_to_payload"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    data = _data(200_003, 14)
    st = engine.stage(data, mode=mode, decode_unit=du, device=dev)
    enc = engine.encode(st, pack_method=pack_method)
    assert engine.fetch_bytes(enc, engine.decode(enc)) == data


# ---------------------------------------------------------------------------
# F4: units of 1 and 2 bytes (decode_unit == block_size), the kernels'
# scalar branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", corpus.GRID_MODES)
@pytest.mark.parametrize("block_size", [1, 2])
def test_f4_block_sizes_1_and_2_write_the_reference_container(dev, mode,
                                                               block_size):
    """api.compress at block sizes 1 and 2 (300,001 units and 150,001) on
    the card writes the CPU's container, which is the reference's (the
    parameter grid's table), with each pack method; api.decompress on
    the card reads it."""
    x = corpus.grid_inputs()["corpus"]
    want = corpus.load_grid_table()["containers"][corpus.grid_key(
        "corpus", mode, block_size, block_size, True)]
    blob = api.compress(x, mode=mode, block_size=block_size, device="cpu")
    assert [len(blob), hashlib.sha256(blob).hexdigest()] == want
    for pm in engine.PACK_METHODS:
        assert api.compress(x, mode=mode, block_size=block_size, device=dev,
                            pack_method=pm) == blob
    assert api.decompress(blob, device=dev) == x


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("n_out", [1, 2])
def test_f4_k7_at_unit_widths_1_and_2(dev, mode, n_out):
    """K7's scalar store path at units of 1 and 2 bytes against its plain
    version, on the engine's rows."""
    st = engine.stage(_data(20_001, n_out), mode=mode, block_size=n_out,
                      device=dev)
    enc = engine.encode(st)
    words, n_dec, _, t = engine.decode_inputs(enc)
    args = (words, n_dec, t["lim"], t["base"], t["first_code"],
            t["sorted_syms"])
    markov = get_model(mode).markov
    out = decode_cuda.decode_units(*args, n_out=n_out, markov=markov)
    assert _equal(out, decode_cuda.decode_units_plain(*args, n_out=n_out,
                                                      markov=markov))
    assert engine.fetch_bytes(enc, out) == _data(20_001, n_out)


@pytest.mark.parametrize("du", [1, 2])
def test_f4_compact_units_at_du_1_and_2_without_literals(dev, du):
    """K10+K8 at units of 1 and 2 bytes (the substreams of no block, so
    no literal rows) against its plain version on the card and on the
    CPU."""
    R, W = 1001, bitpack.words_for_block(du)
    rng = np.random.default_rng(du)
    words = rng.integers(-(1 << 31), 1 << 31, (R, W),
                         dtype=np.int64).astype(np.int32)
    u = rng.integers(0, 256, (R, du), dtype=np.uint8)
    nv = np.full(R, du, np.int32)
    nv[-1] = 1
    wl = (rng.integers(0, du * 15 + 1, R) + 31) // 32
    offs = np.concatenate([[0], np.cumsum(wl)])
    host = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (words, u, nv, offs, np.zeros(R, bool))]
    got = stages_cuda.compact_units(*(a.to(dev) for a in host),
                                    int(offs[-1]))
    want = stages_cuda.compact_units(*host, int(offs[-1]))
    assert _equal(got.cpu(), want)
    assert _equal(got, bitpack.compact_units_plain(
        *(a.to(dev) for a in host), int(offs[-1])))


@pytest.mark.parametrize("mode", corpus.GRID_MODES)
def test_f4_served_compress_at_block_size_1(dev, mode):
    """POST /compress?block_size=1 on the card answers 200 with the
    reference's bytes (the parameter grid's table), where the handler
    dropped the connection before."""
    import threading
    import urllib.request
    x = corpus.grid_inputs()["skew4"]
    srv = serve.make_server("127.0.0.1", 0, device=dev)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_port}/compress?mode={mode}"
            "&block_size=1", data=x, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200
            blob = r.read()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    assert [len(blob), hashlib.sha256(blob).hexdigest()] == (
        corpus.load_grid_table()["containers"][corpus.grid_key(
            "skew4", mode, 1, 1, True)])


# ---------------------------------------------------------------------------
# F5: header fields that sized the decode with no bound
# ---------------------------------------------------------------------------

F5 = chip_smoke.f5_containers()


@pytest.mark.parametrize("route", ["api", "hybrid"])
@pytest.mark.parametrize("case", [k for k, v in F5.items() if v[1]])
def test_f5_refused_on_the_card_before_any_launch(dev, route, case):
    bad, want = F5[case]
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    with pytest.raises(ValueError, match=want):
        if route == "api":
            api.decompress(bad, device=dev)
        else:
            hybrid.decompress(bad, host_fraction=0.5, device=dev)
    torch.cuda.synchronize()
    assert not any(_build.LAUNCHES.values())


def _peak_decode(blob: bytes, dev) -> int:
    """Peak bytes allocated over the start by api.decompress(blob), which
    must give F5_TEXT with one K7 launch."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.max_memory_allocated()
    _build.LAUNCHES.clear()
    assert api.decompress(blob, device=dev) == chip_smoke.F5_TEXT
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_units"] == 1
    return torch.cuda.max_memory_allocated() - before


@pytest.mark.parametrize("case", [k for k, v in F5.items() if not v[1]])
def test_f5_legacy_block_size_decodes_in_short_rows(dev, case):
    """K7 runs at n_out 528 (the 520-byte block rounded up to 16), where
    the block size would exceed its INT32_MAX guard; the decode allocates
    no more than the clean container's (its tables, ~1.1 MB)."""
    clean = _peak_decode(chip_smoke.f5_source(legacy=True), dev)
    assert _peak_decode(F5[case][0], dev) <= clean


@pytest.mark.parametrize("block", [0, 1 << 32])
def test_f5_writers_refuse_before_any_launch(dev, block):
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    for writer in (api.compress, hybrid.compress):
        with pytest.raises(ValueError, match="block_size"):
            writer(chip_smoke.F5_TEXT, block_size=block, device=dev)
    assert not any(_build.LAUNCHES.values())


# ---------------------------------------------------------------------------
# P1-P3, the calibration probes (csrc/probes.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [0, 1, 3, 64])
@pytest.mark.parametrize("name", [*probes.LOOP_BODIES, *probes.DEP_BODIES])
def test_loop_calib_kernel_equals_plain(dev, name, iters):
    """Every carry of the grid (one-warp blocks; `wide` split over 8
    lanes) equals the plain version, and thread 0 writes its cycles."""
    variant, n_ops = {**probes.LOOP_BODIES, **probes.DEP_BODIES}[name]
    x = probes.loop_input(dev)
    cycles = torch.full((1,), -1, dtype=torch.int64, device=dev)
    _build.LAUNCHES.clear()
    got = probes.loop_calib(name, x, iters, cycles)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"loop_calib/{name}"] == 1
    assert torch.equal(got, probes.loop_calib_plain(variant, n_ops, x, iters))
    assert int(cycles) >= 0


@pytest.mark.parametrize("steps", [0, 1, 3, 64])
@pytest.mark.parametrize("name", probes.VPU_BODIES)
def test_vpu_probe_kernel_equals_plain(dev, name, steps):
    """Every carry of the grid (a warp a carry, or 8 columns a CTA for
    the fetch cores) equals the plain version, and thread 0 of block 0
    writes its cycles."""
    x = probes.vpu_input(dev)
    operand = probes.vpu_operand(name, dev)
    cycles = torch.full((1,), -1, dtype=torch.int64, device=dev)
    _build.LAUNCHES.clear()
    got = probes.vpu_probe(name, x, steps, operand, cycles)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"vpu_probe/{name}"] == 1
    assert torch.equal(got, probes.vpu_probe_plain(name, x, steps, operand))
    assert int(cycles) >= 0


@pytest.mark.parametrize("name", ["pick256_i32", "fetch316_i8_matmul",
                                  "fetch316_bf16_matmul"])
def test_vpu_probe_kernel_on_random_carries(dev, name):
    """Carries of every value in every column (a permutation of 0..255,
    four times over), 3 steps: the fetch cores' one-hot images and
    column sums hold for each of a CTA's 8 columns."""
    perm = np.random.default_rng(11).permutation(1024) & 255
    x = torch.from_numpy(perm.astype(np.int32).reshape(8, 128)).to(dev)
    operand = probes.vpu_operand(name, dev)
    got = probes.vpu_probe(name, x, 3, operand)
    assert torch.equal(got, probes.vpu_probe_plain(name, x, 3, operand))


def test_i8_matmul_kernel_equals_plain_library_and_exact(dev):
    a, b = probes.i8_matmul_inputs(dev)
    got = probes.i8_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.i8_matmul_plain(a, b))
    assert torch.equal(got, torch._int_mm(a, b))
    exact = a.cpu().numpy().astype(np.int64) @ b.cpu().numpy().astype(
        np.int64)
    assert (got.cpu().numpy() == exact).all()
    rng = np.random.default_rng(3)           # another shape: 48 x 40 x 96
    a2 = torch.from_numpy(rng.integers(-128, 128, (48, 96), np.int8)).to(dev)
    b2 = torch.from_numpy(rng.integers(-128, 128, (96, 40), np.int8)).to(dev)
    assert torch.equal(probes.i8_matmul(a2, b2), probes.i8_matmul_plain(a2,
                                                                        b2))


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch._int_mm on operands zero-padded to multiples of 128 (its
    cuBLASLt call refuses some small shapes, (48, 96, 40) among them),
    cut back to (M, N): the same product."""
    (M, K), N = a.shape, b.shape[1]
    Mp, Kp, Np = (-(-x // 128) * 128 for x in (M, K, N))
    ap = torch.zeros((Mp, Kp), dtype=a.dtype, device=a.device)
    bp = torch.zeros((Kp, Np), dtype=b.dtype, device=b.device)
    ap[:M, :K], bp[:K, :N] = a, b
    return torch._int_mm(ap, bp)[:M, :N]


@pytest.mark.parametrize("M,K,N", [(16, 32, 8), (48, 96, 40),
                                   (272, 288, 264), (256, 256, 256)])
def test_i8_matmul_wgmma_shapes_equal_plain_library_and_int64(dev, M, K, N):
    """Tiles cut by M, N and K (K % 128 != 0, N % 16 != 0: the 8-byte B
    loads), one launch each."""
    rng = np.random.default_rng(M * K * N)
    a_np = rng.integers(-128, 128, (M, K), np.int8)
    b_np = rng.integers(-128, 128, (K, N), np.int8)
    a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
    _build.LAUNCHES.clear()
    got = probes.i8_matmul(a, b)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mosaic_probe/i8_matmul"] == 1
    assert torch.equal(got, probes.i8_matmul_plain(a, b))
    assert torch.equal(got, _int_mm(a, b))
    assert (got.cpu().numpy()
            == a_np.astype(np.int64) @ b_np.astype(np.int64)).all()


def test_i8_matmul_refuses_unaligned_views(dev):
    flat = torch.zeros(64 * 64 + 16, dtype=torch.int8, device=dev)
    ok = flat[:64 * 64].view(64, 64)
    with pytest.raises(ValueError, match="aligned"):
        probes_cuda.i8_matmul(flat[8:8 + 64 * 64].view(64, 64), ok)
    with pytest.raises(ValueError, match="aligned"):
        probes_cuda.i8_matmul(ok, flat[4:4 + 64 * 64].view(64, 64))
    assert torch.equal(probes_cuda.i8_matmul(ok, flat[8:8 + 64 * 64]
                                             .view(64, 64)),
                       torch.zeros((64, 64), dtype=torch.int32, device=dev))


def test_probe_sass_has_tensor_core_products_and_shared_memory():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    counts = probes_cuda.sass_counts()
    assert counts["vpu_fetch_kernelILb0E"]["IGMMA"] > 0
    assert counts["vpu_fetch_kernelILb1E"]["HGMMA"] > 0
    assert counts["vpu_fetch_kernelILb0E"].get("IMMA", 0) == 0
    assert counts["vpu_fetch_kernelILb1E"].get("HMMA", 0) == 0
    assert counts["i8_matmul_kernel"]["IGMMA"] > 0
    assert counts["i8_matmul_kernel"].get("IMMA", 0) == 0
    assert counts["loop_calib_kernelILi1ELi8E"]["LDS"] > 0
    assert counts["loop_calib_kernelILi1ELi8E"]["STS"] > 0


@pytest.mark.parametrize("name", ["null_loop", "pick256_i32",
                                  "fetch316_i8_matmul"])
def test_probe_loop_cycles_grow_with_steps(dev, name):
    """The loop runs every step: its clock64() cycles grow 4x at least
    from 64 steps to 1,024, as chip_smoke.py requires (no step folded or
    hoisted)."""
    x = probes.vpu_input(dev)
    operand = probes.vpu_operand(name, dev)
    cycles = {}
    for steps in (64, 1024):
        c = torch.zeros(1, dtype=torch.int64, device=dev)
        probes.vpu_probe(name, x, steps, operand, cycles=c)
        cycles[steps] = int(c)
    assert cycles[1024] >= 4 * cycles[64] > 0


def test_probe_entry_points_on_the_card(dev):
    res = loop_calib.run(dev, iters=64)
    assert res["platform"] == "gpu" and res["device"]
    assert all(res["launches"][f"loop_calib/{n}"] == 4
               for n in (*probes.LOOP_BODIES, *probes.DEP_BODIES))
    res = vpu_probe.run(dev, 64)
    assert all(res["launches"][f"vpu_probe/{n}"] == 4
               for n in probes.VPU_BODIES)
    res = mosaic_probe.run(dev, corpus_bytes=1 << 20)
    assert res["i8_matmul"] is True and res["hist_pallas_ok"] is True
    assert res["launches"] == {"markov_hist": 4, "mosaic_probe/i8_matmul": 4}


# F7 and BASELINE config 5 (the multigb phase): counts past int32, and the
# engine past 2**31 bytes. MULTIGB_BYTES of zeros hold one cell that often.
N_F7 = chip_smoke.MULTIGB_BYTES


@pytest.fixture
def zeros_f7(dev):
    return bytes(N_F7)


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_f7_histogram_of_zeros_past_int32_equals_native_counts(
        dev, zeros_f7, mode):
    """K1 (cell (0, 0)) and K2 (byte 0) count every one of the 2.25 GiB
    of zeros, as the native host counts do (int64); the reference's int32
    counts wrap there."""
    from mhc_tpu_torch.utils import native
    st = engine.stage(zeros_f7, mode=mode, device=dev)
    hist = (histogram_cuda.markov_hist if mode == "markov"
            else histogram_cuda.order0_hist)
    counts = hist(st.units, st.n_valid)
    assert counts.dtype == torch.int64
    flat = np.frombuffer(zeros_f7, np.uint8)
    host = (native.hist_markov(flat, st.decode_unit) if mode == "markov"
            else native.hist_order0(flat))
    assert int(counts.reshape(-1)[0]) == N_F7 > 2 ** 31 - 1
    np.testing.assert_array_equal(counts.cpu().numpy(), host)


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_f7_engine_zeros_container_equals_native_route(dev, zeros_f7, mode):
    """The engine's container of the 2.25 GiB of zeros (its counts past
    int32 in one cell) is the native host route's, and decodes to the
    zeros."""
    st = engine.stage(zeros_f7, mode=mode, device=dev)
    enc = engine.encode(st)
    assert engine.fetch_bytes(enc, engine.decode(enc)) == zeros_f7
    del st
    blob = engine.assemble_container(enc, zlib.crc32(zeros_f7))
    del enc
    torch.cuda.empty_cache()
    assert blob == hybrid.compress(zeros_f7, mode=mode, host_fraction=1.0,
                                   device=dev)


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_f7_histogram_kernels_at_100mb_equal_plain_versions(dev, mode):
    """K1 and K2 with their int64 tables still equal their plain versions
    on the 100 MB corpus (chip_smoke.py's main-path inputs)."""
    st = engine.stage(corpus.make_corpus(chip_smoke.CORPUS_BYTES),
                      mode=mode, device=dev)
    hist, plain = ((histogram_cuda.markov_hist,
                    histogram_cuda.markov_hist_plain) if mode == "markov"
                   else (histogram_cuda.order0_hist,
                         histogram_cuda.order0_hist_plain))
    got = hist(st.units, st.n_valid)
    assert got.dtype == torch.int64
    assert torch.equal(got, plain(st.units, st.n_valid))


def test_multigb_entry_point_on_the_card(dev, tmp_path):
    """multigb.run at 1 MB segments over 3 segments and a tail: the chain
    of api.compress containers, byte-equal round trip, the device's
    fields and the kernels launched."""
    from mhc_tpu_torch.bench import multigb
    data = corpus.tiled_corpus(3 * (1 << 20) + 12_345, 1 << 20)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    dst = tmp_path / "out.mhc"
    res = multigb.run(str(src), 1 << 20, dev, dst=str(dst))
    chain = b"".join(api.compress(data[i: i + (1 << 20)], device=dev)
                     for i in range(0, len(data), 1 << 20))
    assert dst.read_bytes() == chain
    assert res["roundtrip_ok"] is True and res["n_segments"] == 4
    assert res["platform"] == "gpu" and res["device"]
    assert res["peak_device_bytes"]["compress"] > 0
    assert res["launches"]["compress"]["code_tables"] == 4
    assert res["launches"]["decompress"]["decode_units"] == 4


@pytest.mark.parametrize("pack_method", engine.PACK_METHODS)
@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_launch_spans_name_every_launch(dev, monkeypatch, mode, pack_method):
    """Under torch.profiler each kernel wrapper's CUDA branch is one
    `mhc.launch.<kernel>` range, named as `_build.LAUNCHES` counts it, in
    the engine and in the api; a trace changes no byte, and no span
    synchronises the card."""
    from torch.profiler import ProfilerActivity, profile
    from mhc_tpu_torch.utils import metrics
    data = _data(300_001, 5)
    st = engine.stage(data, mode=mode, device=dev)
    plain = engine.encode(st, pack_method=pack_method)
    plain_rows = engine.decode(plain)
    blob = api.compress(data, mode=mode, device=dev, pack_method=pack_method)
    torch.cuda.synchronize(dev)
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    _build.LAUNCHES.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            metrics.tracing() as tr:
        enc = engine.encode(st, pack_method=pack_method)
        rows = engine.decode(enc)
        traced = api.compress(data, mode=mode, device=dev,
                              pack_method=pack_method)
        out = api.decompress(traced, device=dev)
    monkeypatch.undo()
    torch.cuda.synchronize(dev)
    assert not syncs
    names = [e.name for e in prof.events() if e.name.startswith("mhc.")]
    launches = collections.Counter(n[len("mhc.launch."):] for n in names
                                   if n.startswith("mhc.launch."))
    assert launches == _build.LAUNCHES
    assert {"mhc.wait.bits", "mhc.wait.d2h", "mhc.engine.plan",
            "mhc.engine.decode_plan", "mhc.engine.upload"} <= set(names)
    # every launch inside an engine or an api span of the same call
    for s in tr.spans:
        if s.name.startswith("mhc.launch."):
            assert s.parent is not None
    assert traced == blob and out == data
    assert torch.equal(enc.payload, plain.payload)
    assert torch.equal(rows, plain_rows)
