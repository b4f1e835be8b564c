"""K11, the device table build, against the JAX package on the CPU.

`code_lengths_plain` (what the port's `ops.huffman.code_lengths` runs on
a CPU tensor) must equal `mhc_tpu.ops.huffman.code_lengths(
rescale_counts_jax(c))` and `code_lengths_np` row for row, tolerance 0:
an integer codec's tables admit no other. JAX's int32 cannot hold a row
total of 2**31 or more, so those rows are held against numpy only. The
engine's two table builds (K11's plain version and the host builder)
then write the same containers as `mhc_tpu.api.compress`.
"""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhc_tpu import api as jax_api
from mhc_tpu.ops import huffman as jax_huffman
from mhc_tpu_torch import api, engine
from mhc_tpu_torch.models.entropy import EntropyModel, get_model
from mhc_tpu_torch.ops import huffman
from mhc_tpu_torch.ops.kernels import huffman_cuda
from tests.corpus import english_like, mixed_binary


def _fib(n_nonzero: int = 256) -> np.ndarray:
    """Fibonacci counts (capped at 2**22, so a row's total stays int32):
    code lengths far past 15, the repair's case."""
    f = np.zeros(256, np.int64)
    a, b = 1, 1
    for i in range(n_nonzero):
        f[i], (a, b) = a, (b, min(a + b, 1 << 22))
    return f


def _straddle(total: int) -> np.ndarray:
    c = np.full(256, total // 256, np.int64)
    c[0] += total - int(c.sum())
    return c


def _one(*pairs) -> np.ndarray:
    c = np.zeros(256, np.int64)
    for s, v in pairs:
        c[s] = v
    return c


def _corpus_counts(data: bytes, mode: str) -> np.ndarray:
    units, n_valid = api.blockify(data, 4096)
    return get_model(mode).histogram(
        torch.from_numpy(units), torch.from_numpy(n_valid)).numpy().reshape(
            -1, 256).astype(np.int64)


CASES = {
    "markov_english": lambda: _corpus_counts(english_like(256 << 10, 1),
                                             "markov"),
    "markov_mixed": lambda: _corpus_counts(mixed_binary(256 << 10, 2),
                                           "markov"),
    "order0_mixed": lambda: _corpus_counts(mixed_binary(256 << 10, 2),
                                           "huffman"),
    "synthetic": lambda: np.stack([
        np.zeros(256, np.int64), _one((42, 999)), _one((1, 7), (200, 1)),
        np.full(256, 5, np.int64), _one((0, 1), (255, 1), (128, 1)),
        _fib(), np.random.default_rng(0).permutation(_fib()), _fib(40),
        np.where(np.arange(256) % 2 == 0, _fib(), 0)]),
    "totals_straddling_2_28": lambda: np.stack([
        _straddle(t) for t in (2 ** 28 - 256, 2 ** 28 - 1, 2 ** 28,
                               2 ** 28 + 256, 2 ** 29 + 7, 2 ** 30 + 12345,
                               2 ** 31 - 1)]),
    "random_seeded": lambda: np.concatenate([
        (rng.integers(0, 10 ** int(rng.integers(1, 7)), (32, 256))
         * (rng.random((32, 256)) < rng.random((32, 1))))
        for rng in map(np.random.default_rng, range(4))]),
}


def _jax_lengths(counts: np.ndarray) -> np.ndarray:
    """The JAX build on (rows, 256) counts, padded to 256 rows so that
    every case shares one compiled shape."""
    rows = counts.shape[0]
    padded = np.zeros((256, 256), np.int32)
    padded[:rows] = counts
    got = jax_huffman.code_lengths(
        jax_huffman.rescale_counts_jax(jnp.asarray(padded)))
    return np.asarray(got)[:rows]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_jax_and_numpy(case):
    counts = CASES[case]()
    assert counts.sum(axis=1).max() < 2 ** 31
    got = huffman_cuda.code_lengths_plain(torch.from_numpy(counts)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _jax_lengths(counts))
    np.testing.assert_array_equal(
        got, np.stack([jax_huffman.code_lengths_np(r) for r in counts]))
    # int32 counts, and the port's entry point on (..., 256) shapes
    c32 = torch.from_numpy(counts.astype(np.int32))
    np.testing.assert_array_equal(huffman.code_lengths(c32).numpy(), got)
    np.testing.assert_array_equal(
        huffman.code_lengths(c32[0]).numpy(), got[0])


# ---------------------------------------------------------------------------
# K11's merge as csrc/huffman.cu `merge` runs it, transcribed: both queue
# heads in registers, the entries behind them loaded a step ahead
# ---------------------------------------------------------------------------

_INF = 1 << 30


def _merge_straight(leaf_w: list, m: int):
    """The two-queue merge as the reference writes it (code_lengths_np):
    every pick reads both heads from memory. (leaf_parent, int_parent,
    int_w) over m leaves and m - 1 internal nodes (the root, node m - 2,
    has no parent)."""
    int_w, lp, ip = [None] * (m - 1), [-1] * m, [-1] * (m - 2)
    i = j = 0
    for t in range(m - 1):
        total = 0
        for _ in range(2):
            lw = leaf_w[i] if i < m else _INF
            iw = int_w[j] if j < t else _INF
            if lw <= iw:
                lp[i], i, total = t, i + 1, total + lw
            else:
                ip[j], j, total = t, j + 1, total + iw
        int_w[t] = total
    return lp, ip, int_w


def _parent_step(leaves_by: list, steps: int, n: int, leaf: bool) -> int:
    """One of `parent_steps`' two searches: the first step by which more
    than n leaves (or nodes) were picked, as a branchless binary search
    over spans 128, 64, ..., 1."""
    pos = 0
    for span in (128, 64, 32, 16, 8, 4, 2, 1):
        c = pos + span - 1
        got = (leaves_by[c] if leaf else 2 * (c + 1) - leaves_by[c]
               ) if c < steps else None
        if got is not None and got <= n:
            pos += span
    return pos


def _merge_windowed(leaf_w: list, m: int):
    """`merge`, step for step: l0..l3 and a0..a3 are its registers over
    leaf_w (kInf from m on, padded by 4) and int_w (kInf until written); a
    step's picks read l0, l1, a0 and a1 only; the windows shift by what
    each queue gave (p2-shifted, then p1-shifted), the head of the node
    window becomes min(entry, sum), the next one too unless node t is
    alone (kInf), and l2, l3, a2, a3 are loaded at the end of the step. It
    stores int_w[t] and the leaves picked by step t; the parents follow by
    `parent_steps`. Every load is recorded in issue order with the step
    that issued it."""
    lw_mem = list(leaf_w) + [_INF] * (256 - m + 4)
    iw_mem = [_INF] * 260
    leaves_by = [0] * 256
    loads = []

    def leaf(x, t):
        loads.append(("leaf", x, t))
        return lw_mem[x]

    def node(x, t):
        loads.append(("int", x, t))
        return iw_mem[x]

    lq = [leaf(x, -1) for x in range(4)]
    aq = [_INF] * 4
    i = j = pending = 0
    for t in range(m - 1):
        l0, l1, a0, a1 = lq[0], lq[1], aq[0], aq[1]
        p1 = l0 <= a0
        lw, iw = (l1, a0) if p1 else (l0, a1)
        p2 = lw <= iw
        total = min(l0, a0) + min(lw, iw)
        leaves = p1 + p2
        i += leaves
        iw_mem[t], leaves_by[t] = total, i
        c = [lq[k + p2] for k in range(3)]
        d = [aq[k + (not p2)] for k in range(3)]
        j, pending = j + 2 - leaves, pending + leaves - 1
        lq = [c[k + p1] for k in range(2)] + [leaf(i + 2, t), leaf(i + 3, t)]
        aq = [min(d[not p1], total),
              min(d[1 + (not p1)], total) if pending > 1 else _INF,
              node(j + 2, t), node(j + 3, t)]
    lp = [_parent_step(leaves_by, m - 1, x, True) for x in range(m)]
    ip = [_parent_step(leaves_by, m - 1, y, False) for y in range(m - 2)]
    return lp, ip, iw_mem[:m - 1], loads


def _lengths_from_merge(w: np.ndarray, merge) -> tuple:
    """(lengths, parents) of one row of rescaled weights through `merge`:
    the leaves in (weight, symbol) order, depths below the root (internal
    node m - 2), the reference's 15-bit repair; m <= 1 rows take their
    special results."""
    present = w > 0
    m = int(present.sum())
    if m <= 1:
        return present.astype(np.uint8), None
    order = np.lexsort((np.arange(256), np.where(present, w, _INF)))
    lp, ip, int_w = merge([int(x) for x in w[order][:m]], m)[:3]
    depth = [0] * (m - 1)
    for t in range(m - 3, -1, -1):
        depth[t] = depth[ip[t]] + 1
    lengths = np.zeros(256, np.int64)
    lengths[order[:m]] = [depth[p] + 1 for p in lp]
    return jax_huffman.limit_lengths_np(lengths), (lp, ip, int_w)


MERGE_CASES = {
    "markov_corpus": lambda: _corpus_counts(english_like(256 << 10, 3),
                                            "markov"),
    "order0_corpus": lambda: _corpus_counts(mixed_binary(256 << 10, 3),
                                            "huffman"),
    "fibonacci_repair": lambda: np.stack([
        _fib(), np.random.default_rng(1).permutation(_fib()), _fib(40),
        _fib(24), np.where(np.arange(256) % 3 == 0, _fib(), 0)]),
    "all_equal": lambda: np.stack([
        np.full(256, 5, np.int64), np.full(256, 1, np.int64),
        np.where(np.arange(256) < 100, 7, 0), np.where(
            np.arange(256) < 4, 1 << 20, 0)]),
    "two_and_three_symbols": lambda: np.stack([
        _one((1, 7), (200, 1)), _one((0, 1), (255, 1)),
        _one((0, 1), (255, 1), (128, 1)), _one((3, 5), (9, 5), (4, 10)),
        _one((3, 1), (9, 2), (4, 1 << 20))]),
    "random_50": lambda: np.stack([
        rng.integers(1, 10 ** int(rng.integers(1, 8)), 256)
        * (rng.random(256) < rng.random())
        for rng in map(np.random.default_rng, range(100, 150))]),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_windowed_merge_equals_straight_merge_and_jax(case):
    counts = MERGE_CASES[case]()
    jax_rows = _jax_lengths(counts)
    for row, ref in zip(counts, jax_rows, strict=True):
        w = jax_huffman.rescale_counts(row).astype(np.int64)
        straight, parents = _lengths_from_merge(w, _merge_straight)
        windowed, wparents = _lengths_from_merge(w, _merge_windowed)
        assert wparents == parents
        np.testing.assert_array_equal(windowed, straight)
        np.testing.assert_array_equal(windowed, ref)
        np.testing.assert_array_equal(windowed,
                                      jax_huffman.code_lengths_np(row))
    if case == "fibonacci_repair":
        assert (jax_rows.max(axis=1) == 15).all()


def test_windowed_merge_loads_a_step_ahead_and_inside_its_queues():
    """Four loads a step, issued after its picks, inside the padded
    arrays, two places past the heads: the leaves stream in order, never
    stepping back more than one entry (a step that takes no leaf loads
    its two again); a node load reads a node formed by then (node t
    included, stored just before) or an entry still kInf. No head (l0,
    l1, a0, a1) is loaded: each comes from a register filled a step or
    more before."""
    w = [int(x) for x in sorted(np.random.default_rng(5).integers(
        1, 1000, 200))]
    m = len(w)
    lp, ip, int_w, loads = _merge_windowed(w, m)
    assert len(loads) == 4 + 4 * (m - 1)
    leaves = [x for kind, x, t in loads if kind == "leaf" and t >= 0]
    assert leaves[:2] in ([2, 3], [3, 4], [4, 5]) and max(leaves) <= 259
    assert all(b >= a - 1 for a, b in zip(leaves, leaves[1:]))
    nodes = [(x, t) for kind, x, t in loads if kind == "int"]
    assert min(x for x, _ in nodes) >= 2 and max(x for x, _ in nodes) <= 259
    assert any(x == t for x, t in nodes) and any(x < t for x, t in nodes)
    assert (lp, ip, int_w) == _merge_straight(w, m)


@pytest.mark.parametrize("shift", [0, 8, 20, 30])
def test_plain_equals_numpy_past_int32_totals(shift):
    """Row totals of 2**31 and beyond (int64 counts, as the sharded
    all-reduce gives them): numpy only."""
    rng = np.random.default_rng(shift)
    counts = np.stack([
        rng.integers(1 << 23, 1 << 24, 256).astype(np.int64) << shift,
        _fib() << shift, _straddle(2 ** 31) << shift,
        (rng.integers(0, 1 << 20, 256) << shift)
        * (rng.random(256) < 0.3)])
    got = huffman.code_lengths(torch.from_numpy(counts)).numpy()
    ref = np.stack([jax_huffman.code_lengths_np(r) for r in counts])
    np.testing.assert_array_equal(got, ref)
    # the rescale on the int64 totals is the host builder's
    np.testing.assert_array_equal(
        huffman_cuda.rescale_plain(torch.from_numpy(counts)).numpy(),
        jax_huffman.rescale_counts(counts))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    for bad in (torch.zeros(256, dtype=torch.int64),
                torch.zeros((2, 255), dtype=torch.int64),
                torch.zeros((2, 256), dtype=torch.float32),
                torch.zeros((256, 2), dtype=torch.int32).t()):
        with pytest.raises(ValueError):
            huffman_cuda.code_lengths(bad)
    assert huffman_cuda.code_lengths(
        torch.zeros((0, 256), dtype=torch.int32)).shape == (0, 256)


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_lengths_for_builds_on_the_host_off_a_card(mode, monkeypatch):
    """Off a CUDA card `lengths_for` is the host builder (K11's plain
    version is never reached): a uint8 tensor of the counts' shape equal
    to `code_lengths_np`, for int32 and int64 counts."""
    model = get_model(mode)
    counts = _corpus_counts(mixed_binary(64 << 10, 4), mode)
    counts = counts.reshape((256, 256) if model.markov else (256,))
    monkeypatch.setattr(huffman_cuda, "code_lengths_plain", None)
    ref = np.stack([jax_huffman.code_lengths_np(r)
                    for r in counts.reshape(-1, 256)]).reshape(counts.shape)
    for dt in (torch.int32, torch.int64):
        got = model.lengths_for(torch.from_numpy(counts).to(dt))
        assert got.dtype == torch.uint8 and got.shape == counts.shape
        np.testing.assert_array_equal(got.numpy(), ref)


@functools.lru_cache(maxsize=None)
def _engine_case(mode: str):
    data = mixed_binary(96 << 10, 5)
    return data, jax_api.compress(data, mode=mode, block_size=32768)


@pytest.mark.parametrize("pack_method", ["fused", "dense", "pallas"])
@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_engine_table_builds_write_the_reference(mode, pack_method):
    """The engine's own build (the host's, on the CPU) and K11's plain
    version on the device counts, passed in as `lengths`."""
    data, ref = _engine_case(mode)
    st = engine.stage(data, mode=mode, block_size=32768, device="cpu")
    crc = zlib.crc32(data) & 0xFFFFFFFF
    k11 = huffman.code_lengths(get_model(mode).histogram(st.units,
                                                         st.n_valid))
    blobs = {}
    for build, lengths in (("device", k11), ("host", None)):
        enc = engine.encode(st, lengths=lengths, pack_method=pack_method)
        assert enc.lengths.dtype == np.uint8
        blobs[build] = engine.assemble_container(enc, crc)
    assert blobs["device"] == blobs["host"] == ref


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_api_compress_table_builds_write_the_reference(mode, monkeypatch):
    """api.compress with the CPU's host build, then with the table build
    a card runs (K11, here its plain version) on the summed counts."""
    data, ref = _engine_case(mode)
    assert api.compress(data, mode=mode, block_size=32768,
                        device="cpu") == ref
    monkeypatch.setattr(EntropyModel, "lengths_for",
                        lambda self, counts: huffman.code_lengths(counts))
    assert api.compress(data, mode=mode, block_size=32768,
                        device="cpu") == ref
