"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. This file imports
torch and mhc_tpu_torch only, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import mhc_tpu_torch
from mhc_tpu_torch import api, engine, hybrid
from mhc_tpu_torch.models.entropy import get_model
from mhc_tpu_torch.ops import bitpack
from mhc_tpu_torch.ops import huffman
from mhc_tpu_torch.ops.kernels import (_build, decode_cuda, encode_cuda,
                                       histogram_cuda, huffman_cuda)
from mhc_tpu_torch.parallel import pipeline

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
                          "bubble_pack": 1, **_DEC}),
    ("huffman", "dense", {"order0_hist": 1, "lookup_cl": 1, "pack_cl": 1,
                          **_DEC0}),
    ("huffman", "pallas", {"order0_hist": 1, "lookup_cl": 1,
                           "bubble_pack": 1, **_DEC0})])
def test_launch_counters_count_kernel_launches(dev, mode, pack_method,
                                               expected):
    """The default table build on a card is K11's: once per encode."""
    st = engine.stage(_data(50_000, 1), mode=mode, device=dev)
    _build.LAUNCHES.clear()
    engine.decode(engine.encode(st, pack_method=pack_method))
    assert dict(_build.LAUNCHES) == {**expected, "code_lengths": 1}


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


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("kind", ["skewed", "all15"])
@pytest.mark.parametrize("R,n", [(1, 8192), (7, 8192), (133, 512),
                                 (300, 16384), (45, 1024), (5, 1000)])
def test_k3_and_k7_edges_equal_plain_versions(dev, mode, kind, R, n):
    """K3 (a warp per unit, lane chunks) and K7 (table-driven) at the
    edges: n_valid of 0, 1, 31, 33, 257 and a last unit cut short; one
    unit; R not a multiple of a block or of the warps of the grid; widths
    off the 16-byte paths; all-15-bit codes."""
    markov = mode == "markov"
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
    out = decode_cuda.decode_units(words, *args, n_out=n, markov=markov)
    torch.cuda.synchronize()
    assert torch.equal(out, decode_cuda.decode_units_plain(
        words, *args, n_out=n, markov=markov))
    valid = torch.arange(n, device=dev)[None, :] < nv[:, None]
    assert torch.equal(out[valid], units[valid])


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
    }[kind]


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("kind", ["all_zero", "one_symbol", "two_symbols",
                                  "all_equal", "fibonacci", "over_2_31",
                                  "random"])
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
    build; the engine's two table builds write the same container, K11
    launched by the device build only."""
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
        assert _build.LAUNCHES["code_lengths"] == (build == "device")
        blobs[build] = engine.assemble_container(enc, None)
    assert blobs["device"] == blobs["host"]
    _build.LAUNCHES.clear()
    assert (api.compress(data, mode=mode, device=dev)
            == mhc_tpu_torch.compress(data, mode=mode, device="cpu"))
    assert _build.LAUNCHES["code_lengths"] == 1


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_sharded_world_of_one_on_the_card(dev, mode):
    data = _data(300_001, 6)
    blob = pipeline.compress_sharded(data, mode=mode, device=dev)
    assert blob == mhc_tpu_torch.compress(data, mode=mode, device="cpu")
    assert pipeline.decompress_sharded(blob, device=dev) == data
