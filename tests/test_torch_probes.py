"""The calibration probes P1-P3 of the port (`mhc_tpu_torch.bench`)
against the reference's (`bench/loop_calib.py`, `mosaic_probe.py`,
`vpu_probe.py`), on the CPU, exactly.

The reference's bodies are closures inside each script's `main()`. Each
script is loaded by file path (the root `bench.py` shadows the `bench/`
directory as a package) and its `main()` run with
`jax.experimental.pallas.pallas_call` wrapped so that it runs in
interpret mode and records each call's output; the port's plain version
of every body is held to those outputs with tolerance 0. P1's two
longest chains run too long as plain step loops at the reference's
4,096 steps, so they, like every body, are held at small step counts to a
transcription of the reference's kernel (`bench/loop_calib.py:34-70`),
which is itself held to the recorded outputs at 4,096 steps.
"""

import importlib.util
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mhc_tpu.ops import histogram as jax_histogram
from mhc_tpu.ops.kernels import histogram_pallas
from mhc_tpu_torch.bench import loop_calib, mosaic_probe, probes, vpu_probe
from mhc_tpu_torch.ops import histogram
from mhc_tpu_torch.ops.kernels import probes_cuda
from mhc_tpu_torch.utils.corpus import make_corpus
from tests.torch_fixtures import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
VPU_REF_ITERS = 16
# P1 bodies whose plain step loop at 4,096 steps takes under ~2 s here
LOOP_FAST = ("chain_4", "chain_32", "scratch_8", "store_32", "wide_1",
             "wide_4")


def _load_reference(name: str):
    path = os.path.join(REPO, "bench", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording_pallas_call(mp) -> list:
    """Patch pallas_call to run in interpret mode; returns the list to
    which each created call appends the list of its concrete outputs."""
    calls = []
    real = pl.pallas_call

    def fake(kernel, **kw):
        kw["interpret"] = True
        f = real(kernel, **kw)
        outs = []
        calls.append(outs)

        def run(*args):
            out = f(*args)
            if not isinstance(out, jax.core.Tracer):
                outs.append(np.asarray(out))
            return out
        return run

    mp.setattr(pl, "pallas_call", fake)
    return calls


def _one(outs: list) -> np.ndarray:
    """The output of a call the reference ran several times (warm-up and
    timed runs), checked the same every time."""
    assert outs
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


@pytest.fixture(scope="module")
def loop_ref():
    """bench/loop_calib.py's main() at its 4,096 steps: body -> output."""
    ref = _load_reference("loop_calib")
    with pytest.MonkeyPatch.context() as mp:
        calls = _recording_pallas_call(mp)
        assert ref.main() == 0
    assert len(calls) == len(probes.LOOP_BODIES)
    return {name: _one(outs)
            for name, outs in zip(probes.LOOP_BODIES, calls, strict=True)}


@pytest.fixture(scope="module")
def vpu_ref():
    """bench/vpu_probe.py's main() at argv 16: body -> output."""
    ref = _load_reference("vpu_probe")
    with pytest.MonkeyPatch.context() as mp:
        calls = _recording_pallas_call(mp)
        mp.setattr(sys, "argv", ["vpu_probe.py", str(VPU_REF_ITERS)])
        assert ref.main() == 0
    assert len(calls) == len(probes.VPU_BODIES)
    return {name: _one(outs)
            for name, outs in zip(probes.VPU_BODIES, calls, strict=True)}


@pytest.fixture(scope="module")
def mosaic_ref():
    """bench/mosaic_probe.py's main() with `bench.make_corpus` stubbed to
    64 KB: the int8 product, the matmul histogram and the Pallas one."""
    ref = _load_reference("mosaic_probe")
    small = make_corpus(1 << 16)
    stub = types.ModuleType("bench")
    stub.make_corpus = lambda n: small
    got = {}
    real_matmul = jax_histogram.histogram_markov
    real_pallas = histogram_pallas.markov_hist_pallas

    def matmul_hist(d, nv, **kw):
        out = real_matmul(d, nv, **kw)
        got.setdefault("hist_matmul", np.asarray(out))
        return out

    def pallas_hist(d, nv, **kw):
        out = real_pallas(d, nv, **kw)
        got.setdefault("hist_pallas", np.asarray(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        calls = _recording_pallas_call(mp)
        mp.setitem(sys.modules, "bench", stub)
        mp.setattr(jax_histogram, "histogram_markov", matmul_hist)
        mp.setattr(histogram_pallas, "markov_hist_pallas", pallas_hist)
        assert ref.main() == 0
    got["i8_matmul"] = _one(calls[0])
    got["data"] = np.frombuffer(small, np.uint8).reshape(-1, 8192)
    return got


# ---------------------------------------------------------------------------
# P1 — loop_calib
# ---------------------------------------------------------------------------

def _transcribed_loop_calib(n_ops: int, variant: str, iters: int):
    """bench/loop_calib.py:34-70 with ITERS as a parameter, run as the
    reference runs it (pallas_call, here in interpret mode)."""
    def kern(x_ref, o_ref, scr):
        x = x_ref[:]
        if variant == "wide":
            big = jnp.broadcast_to(x[:, :, None], (8, 128, 64))
            iota = jax.lax.broadcasted_iota(jnp.int32, (8, 128, 64), 2)

        def body(i, c):
            if variant == "chain":
                for k in range(n_ops):
                    c = (c + jnp.uint32(k + 1)) ^ (c >> jnp.uint32(1))
            elif variant == "scratch":
                for k in range(n_ops):
                    scr[:] = c
                    c = scr[:] + jnp.uint32(k + 1)
            elif variant == "store":
                for k in range(n_ops):
                    c = (c + jnp.uint32(k + 1)) ^ (c >> jnp.uint32(1))

                @pl.when((i & 1) == 1)
                def _():
                    o_ref[:] = c
            elif variant == "wide":
                for k in range(n_ops):
                    sel = iota == jnp.broadcast_to(
                        (c[:, :, None] & 63), (8, 128, 64))
                    c = c + jnp.sum(
                        jnp.where(sel, big, jnp.uint32(0)).astype(
                            jnp.int32), axis=2).astype(jnp.uint32)
            return c

        o_ref[:] = jax.lax.fori_loop(0, iters, body, x)

    f = pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.uint32),
        scratch_shapes=[pltpu.VMEM((8, 128), jnp.uint32)],
        interpret=True)
    x = jnp.arange(8 * 128, dtype=jnp.uint32).reshape(8, 128)
    return np.asarray(f(x))


def _loop_plain(name: str, iters: int) -> np.ndarray:
    out = probes.loop_calib(name, probes.loop_input(CPU), iters)
    assert out.dtype == torch.int32 and out.shape == (8, 128)
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("name", LOOP_FAST)
def test_loop_calib_plain_equals_reference_at_4096_steps(loop_ref, name):
    np.testing.assert_array_equal(_loop_plain(name, probes.LOOP_ITERS),
                                  loop_ref[name])


@pytest.mark.parametrize("name", tuple(probes.LOOP_BODIES))
def test_loop_calib_transcription_equals_reference_at_4096_steps(loop_ref,
                                                                 name):
    variant, n_ops = probes.LOOP_BODIES[name]
    np.testing.assert_array_equal(
        _transcribed_loop_calib(n_ops, variant, probes.LOOP_ITERS),
        loop_ref[name])


@pytest.mark.parametrize("iters", [1, 7])
@pytest.mark.parametrize("name", tuple(probes.LOOP_BODIES))
def test_loop_calib_plain_equals_transcription(name, iters):
    variant, n_ops = probes.LOOP_BODIES[name]
    np.testing.assert_array_equal(
        _loop_plain(name, iters),
        _transcribed_loop_calib(n_ops, variant, iters))


@pytest.mark.parametrize("name", tuple(probes.DEP_BODIES))
def test_loop_calib_one_op_chain(name):
    """The calibration body (no reference): n dependent c += c >> 1 a
    step, in numpy's uint32."""
    n_ops = probes.DEP_BODIES[name][1]
    c = np.arange(1024, dtype=np.uint32).reshape(8, 128)
    for _ in range(3):
        for _ in range(n_ops):
            c = c + (c >> np.uint32(1))
    np.testing.assert_array_equal(_loop_plain(name, 3), c)


def test_loop_calib_entry_point_on_the_cpu(loop_ref):
    res = loop_calib.run(CPU, iters=8)
    assert res["iters"] == 8 and res["platform"] == "cpu"
    for name in (*probes.LOOP_BODIES, *probes.DEP_BODIES):
        assert set(res[name]) == {"s", "ns_per_iter", "chk"}
        want = _loop_plain(name, 8).view(np.int32).astype(np.int64).sum()
        assert res[name]["chk"] == want
    assert set(res["fit"]) == {"a_ns_per_step", "b_ns_per_op"}
    assert res["launches"] == {}


# ---------------------------------------------------------------------------
# P3 — vpu_probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", probes.VPU_BODIES)
def test_vpu_probe_plain_equals_reference(vpu_ref, name):
    steps = probes.vpu_steps(name, VPU_REF_ITERS)
    out = probes.vpu_probe(name, probes.vpu_input(CPU), steps,
                           probes.vpu_operand(name, CPU))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), vpu_ref[name])


@pytest.mark.parametrize("steps", [0, 1, 3])
@pytest.mark.parametrize("name", probes.VPU_BODIES)
def test_vpu_probe_plain_at_few_steps(name, steps):
    """Short loops against the body's closed form: each one-hot pick
    returns the carry; each table pick (8 c + row) & 255; each fetch the
    byte sum of its 16 plane entries."""
    c = np.arange(1024).reshape(8, 128) & 255
    rows = np.arange(8)[:, None]
    for _ in range(steps):
        if name == "null_loop":
            c = (c + 1) & 255
        elif name.startswith("pick256_"):
            c = (8 * c + rows) & 255
        elif name.startswith("fetch316_"):
            c = sum((c * 316 + j) & 255 for j in range(16)) & 255
    out = probes.vpu_probe(name, probes.vpu_input(CPU), steps,
                           probes.vpu_operand(name, CPU))
    np.testing.assert_array_equal(out.numpy(), c)


def test_vpu_probe_entry_point_on_the_cpu(vpu_ref):
    res = vpu_probe.run(CPU, VPU_REF_ITERS)
    assert res["iters"] == VPU_REF_ITERS and res["platform"] == "cpu"
    for name in probes.VPU_BODIES:
        assert set(res[name]) == {"s", "us_per_iter", "chk"}
        assert res[name]["chk"] == int(vpu_ref[name].astype(np.int64).sum())


def test_vpu_operands_are_the_references():
    tab = np.arange(256 * 8, dtype=np.int32).reshape(256, 8) & 255
    assert np.array_equal(probes.vpu_operand("pick256_i32", CPU).numpy(), tab)
    assert np.array_equal(probes.vpu_operand("pick256_i8mul_i8sum",
                                              CPU).numpy(), tab.astype(np.int8))
    rng = np.arange(256 * 316, dtype=np.int32).reshape(256, 316)
    assert np.array_equal(probes.vpu_operand("fetch316_i8_matmul",
                                             CPU).numpy(),
                          ((rng & 255) - 128).astype(np.int8))
    bf = probes.vpu_operand("fetch316_bf16_matmul", CPU)
    assert bf.dtype == torch.bfloat16
    assert np.array_equal(bf.float().numpy(), (rng & 255).astype(np.float32))


# ---------------------------------------------------------------------------
# P2 — mosaic_probe
# ---------------------------------------------------------------------------

def test_i8_matmul_plain_equals_reference(mosaic_ref):
    a, b = probes.i8_matmul_inputs(CPU)
    out = probes.i8_matmul(a, b)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), mosaic_ref["i8_matmul"])


def test_matmul_and_k1_histograms_equal_reference(mosaic_ref):
    data = mosaic_ref["data"]
    units = torch.from_numpy(data.copy())
    nv = torch.full((data.shape[0],), 8192, dtype=torch.int32)
    np.testing.assert_array_equal(mosaic_ref["hist_pallas"],
                                  mosaic_ref["hist_matmul"])
    np.testing.assert_array_equal(
        probes.markov_hist_matmul(units, nv).numpy(),
        mosaic_ref["hist_matmul"])
    np.testing.assert_array_equal(histogram.histogram_markov(units,
                                                             nv).numpy(),
                                  mosaic_ref["hist_pallas"])


def test_matmul_histogram_masks_and_chunks():
    """Rows shorter than their stride and more than one chunk of 2^17
    positions: the plain K1's counts."""
    rng = np.random.default_rng(5)
    units = torch.from_numpy(rng.integers(0, 256, (40, 4000), np.uint8))
    nv = torch.from_numpy(rng.integers(0, 4001, 40).astype(np.int32))
    assert torch.equal(probes.markov_hist_matmul(units, nv),
                       histogram.histogram_markov(units, nv))


def test_mosaic_probe_entry_point_on_the_cpu():
    res = mosaic_probe.run(CPU, corpus_bytes=1 << 16)
    assert res["platform"] == "cpu"
    assert res["i8_matmul"] is True and res["hist_pallas_ok"] is True
    assert res["hist_rows"] == [8, 8192]
    for key in ("i8_matmul_s", "hist_matmul_s", "hist_pallas_s"):
        assert res[key] >= 0


# ---------------------------------------------------------------------------
# P2's kernel (csrc/probes.cu `i8_matmul_kernel`): its index maps in numpy
# ---------------------------------------------------------------------------

MM_M, MM_N, MM_K = 64, 128, 128     # kMmM, kMmN, kMmK


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: result byte i is byte (s >> 4 i) & 7 of the
    eight bytes x (0-3), y (4-7)."""
    b = (x | y << 32).to_bytes(8, "little")
    return int.from_bytes(bytes(b[(s >> 4 * i) & 7] for i in range(4)),
                          "little")


def _transpose4x4(x0, x1, x2, x3):
    t0, t1 = _byte_perm(x0, x1, 0x5140), _byte_perm(x2, x3, 0x5140)
    t2, t3 = _byte_perm(x0, x1, 0x7362), _byte_perm(x2, x3, 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def _sw128_write(r: int, k: int) -> int:
    """Where a K-major, 128-byte swizzled tile keeps byte (row r, K byte
    k): TMA's layout for A, load_b_tile's for B."""
    return r * MM_K + (((k // 16) ^ (r % 8)) << 4) + k % 16


def _a_image(a: np.ndarray, m0: int, kt: int) -> np.ndarray:
    """A's 64 x 128-byte TMA box at K step kt: zero past M and K."""
    M, K = a.shape
    img = np.zeros(MM_M * MM_K, np.uint8)
    for r in range(MM_M):
        for k in range(MM_K):
            if m0 + r < M and kt * MM_K + k < K:
                img[_sw128_write(r, k)] = a[m0 + r, kt * MM_K + k]
    return img


def _b_image(b: np.ndarray, n0: int, kt: int) -> np.ndarray:
    """fetch_b_tile then store_b_tile, thread by thread: 8 rows x 16
    columns loaded (16 bytes, or two 8-byte halves where N % 16 != 0;
    zero past K and N), transposed by byte_perm, stored as 16 runs of 8 K
    bytes. Every byte of the image must be written exactly once."""
    K, N = b.shape
    img = np.zeros(MM_N * MM_K, np.uint8)
    writes = np.zeros(MM_N * MM_K, np.int32)
    vec16 = N % 16 == 0
    for tid in range(128):
        kg, cn = tid & 15, tid >> 4
        n = n0 + 16 * cn
        w = np.zeros((8, 4), np.int64)
        for j in range(8):
            k = kt * MM_K + 8 * kg + j
            row = np.zeros(16, np.uint8)
            if k < K and n < N:
                if vec16 or n + 8 < N:
                    row[:] = b[k, n:n + 16].view(np.uint8)
                else:
                    row[:8] = b[k, n:n + 8].view(np.uint8)
            w[j] = row.view("<u4")
        for c in range(4):
            lo = _transpose4x4(*(int(w[j, c]) for j in range(4)))
            hi = _transpose4x4(*(int(w[j, c]) for j in range(4, 8)))
            for bb in range(4):
                nl = 16 * cn + 4 * c + bb
                off = (nl * MM_K + (((kg >> 1) ^ (nl & 7)) << 4)
                       + ((kg & 1) << 3))
                img[off:off + 8] = np.frombuffer(
                    (lo[bb] | hi[bb] << 32).to_bytes(8, "little"), np.uint8)
                writes[off:off + 8] += 1
    assert (writes == 1).all()
    return img


def _desc_read(img: np.ndarray, rows: int, ks: int) -> np.ndarray:
    """The (rows, 32) operand a wgmma k-step reads through the descriptor
    sw128_desc(base) + 2 ks: 8-row groups 1,024 bytes apart (SBO), rows
    of 128 bytes, the start 32 ks bytes in, and the 128-byte swizzle on
    the address (bits 4-6 ^= bits 7-9)."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    addr = (r // 8) * 1024 + (r % 8) * 128 + 32 * ks + k
    return img[addr ^ (((addr >> 7) & 7) << 4)].view(np.int8)


def _i8_matmul_transcribed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The kernel's grid, K steps, wgmma k-steps and epilogue over numpy
    images; D's accumulator fragment mapped to (row, col) and masked past
    M and N, every element of D stored exactly once."""
    (M, K), N = a.shape, b.shape[1]
    out = np.zeros((M, N), np.int64)
    stores = np.zeros((M, N), np.int32)
    for bx in range(-(-M // MM_M)):
        for by in range(-(-N // MM_N)):
            m0, n0 = bx * MM_M, by * MM_N
            acc = np.zeros((MM_M, MM_N), np.int64)
            for kt in range(-(-K // MM_K)):
                ai, bi = _a_image(a, m0, kt), _b_image(b, n0, kt)
                for ks in range(MM_K // 32):
                    acc += (_desc_read(ai, MM_M, ks).astype(np.int64)
                            @ _desc_read(bi, MM_N, ks).astype(np.int64).T)
            for tid in range(128):
                warp, lane = tid >> 5, tid & 31
                for c in range(MM_N // 8):
                    for e in range(4):
                        row = 16 * warp + lane // 4 + 8 * (e // 2)
                        col = 8 * c + 2 * (lane % 4) + e % 2
                        if m0 + row < M and n0 + col < N:
                            out[m0 + row, n0 + col] = acc[row, col]
                            stores[m0 + row, n0 + col] += 1
    assert (stores == 1).all()
    return out


@pytest.mark.parametrize("M,K,N", [(256, 256, 256), (48, 96, 40),
                                   (272, 288, 264)])
def test_i8_matmul_index_maps_rebuild_the_product(M, K, N):
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-128, 128, (M, K), np.int8)
    b = rng.integers(-128, 128, (K, N), np.int8)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(_i8_matmul_transcribed(a, b), exact)
    np.testing.assert_array_equal(
        probes.i8_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        exact)


def test_i8_matmul_transpose_selectors():
    """byte_perm's selectors turn four rows of four bytes into columns."""
    rows = [0x03020100, 0x13121110, 0x23222120, 0x33323130]
    assert _transpose4x4(*rows) == [0x30201000, 0x31211101, 0x32221202,
                                    0x33231303]


# ---------------------------------------------------------------------------
# The split bodies (csrc/probes.cu): lane j of a carry's group computes the
# terms j + S q in the body's type, and a butterfly of shuffles (lane
# distance 1, 2, 4, ...) adds the S partial sums; replayed in numpy
# ---------------------------------------------------------------------------

PICK_LANES = 32          # kPickLanes: P3's lanes a carry
WIDE_SPLIT = 8           # kWideSplit: P1 `wide`'s lanes a carry
SPLIT_BODIES = tuple(b for b in probes.VPU_BODIES
                     if b != "null_loop" and b not in probes.FETCH_BODIES)


def _butterfly(p: np.ndarray) -> np.ndarray:
    """(carries, S) partials -> the sum every lane holds after the
    shuffles, added in the partials' own dtype (numpy wraps ints)."""
    lanes = np.arange(p.shape[1])
    o = 1
    while o < p.shape[1]:
        p = p + p[:, lanes ^ o]
        o <<= 1
    assert (p == p[:, :1]).all()
    return p[:, 0]


def _vpu_split_step(name: str, c: np.ndarray, tab: np.ndarray | None):
    """One step of a split P3 body for the (1,024,) carries c."""
    j = np.arange(PICK_LANES)[None, :, None]
    q = np.arange(256 // PICK_LANES)[None, None, :]
    k = j + PICK_LANES * q                                # (1, 32, 8)
    cc = c[:, None, None]
    sel = cc == k
    if name == "onehot_i32cmp_i8cast_plus_pick":
        s = (sel.astype(np.int8).astype(np.int32) * k).sum(-1,
                                                          dtype=np.int32)
    elif name == "onehot_bf16cmp_plus_pick_bf16":
        # 0 or k times k's bf16 (exact below 256), summed in float32
        s = (sel * k).astype(np.float32).sum(-1, dtype=np.float32)
    elif name == "onehot_16x16_i8mul_plus_pick":
        lo = ((cc & 15) == (j & 15)).astype(np.int8)
        hi = ((cc >> 4) == 2 * q + (j >> 4)).astype(np.int8)
        s = ((hi * lo).astype(np.int8).astype(np.int32) * k).sum(
            -1, dtype=np.int32)
    else:
        # the carry's row of the transposed table, at this lane's k
        t = tab.T[np.arange(1024) >> 7][:, k[0]]          # (1024, 32, 8)
        if name == "pick256_i32":
            s = np.where(sel, t, 0).astype(np.int32).sum(-1, dtype=np.int32)
        elif name == "pick256_f32":
            s = np.where(sel, t, 0).astype(np.float32).sum(-1,
                                                           dtype=np.float32)
        else:
            prod = sel.astype(np.int8) * t.astype(np.int8)   # int8 wrap
            if name == "pick256_i8mul_i32sum":
                s = prod.astype(np.int32).sum(-1, dtype=np.int32)
            else:
                s = np.zeros(prod.shape[:2], np.int8)
                for qq in range(prod.shape[2]):
                    s = (s + prod[..., qq]).astype(np.int8)
    return _butterfly(s).astype(np.int32) & 255


@pytest.mark.parametrize("steps", [1, 3, 64])
@pytest.mark.parametrize("name", SPLIT_BODIES)
def test_vpu_split_sums_equal_plain(name, steps):
    operand = probes.vpu_operand(name, CPU)
    tab = None if operand is None else operand.numpy()
    c = probes.vpu_input(CPU).numpy().reshape(-1).astype(np.int32)
    for _ in range(steps):
        c = _vpu_split_step(name, c, tab)
    want = probes.vpu_probe_plain(name, probes.vpu_input(CPU), steps,
                                  operand)
    np.testing.assert_array_equal(c.reshape(8, 128), want.numpy())


@pytest.mark.parametrize("steps", [1, 3, 64])
@pytest.mark.parametrize("name", ["wide_1", "wide_4"])
def test_loop_wide_split_sums_equal_plain(name, steps):
    n_ops = probes.LOOP_BODIES[name][1]
    x0 = np.arange(1024, dtype=np.uint32)
    m = (np.arange(WIDE_SPLIT)[:, None]
         + WIDE_SPLIT * np.arange(64 // WIDE_SPLIT)[None, :])  # (8, 8)
    c = x0.copy()
    for _ in range(steps):
        for _ in range(n_ops):
            sel = m[None] == (c & np.uint32(63))[:, None, None]
            part = np.where(sel, x0[:, None, None], np.uint32(0)).sum(
                -1, dtype=np.uint32)
            c = c + _butterfly(part)
    np.testing.assert_array_equal(c.reshape(8, 128),
                                  _loop_plain(name, steps))


# ---------------------------------------------------------------------------
# The fetch cores (csrc/probes.cu `vpu_fetch_kernel`): the plane's and the
# one-hot's shared-memory images, the wgmma descriptors' reads and the
# column sums, replayed in numpy
# ---------------------------------------------------------------------------

FETCH_ROWS, FETCH_N, ATOM = 320, 8, 128


def _sw128_offset(r, kb, block):
    """sw128_offset: K byte kb of row r, atoms `block` bytes apart."""
    return ((kb // ATOM) * block + r * ATOM
            + ((((kb % ATOM) >> 4) ^ (r & 7)) << 4) + (kb & 15))


def _fetch_a_image(plane: np.ndarray, elem: int) -> np.ndarray:
    """The kernel's load of P^T, item by item: P^T rows 4 w .. 4 w + 3 (a
    word of each of P's rows; word 79 zero) at K chunk kc, transposed by
    byte_perm into 4 rows of 16 bytes; every byte written once."""
    atoms = 256 * elem // ATOM
    img = np.zeros(5 * atoms * 64 * ATOM, np.uint8)
    writes = np.zeros(img.size, np.int32)
    raw = np.zeros((256, FETCH_ROWS * elem), np.uint8)
    raw[:, :316 * elem] = plane.view(np.uint8).reshape(256, 316 * elem)
    words = raw.view("<u4") if elem == 1 else raw.view("<u8")  # (256, 80)
    for kc in range(256 * elem // 16):
        for w in range(FETCH_ROWS // 4):
            rows = [[0] * 4 for _ in range(4)]
            if elem == 2:
                v = [int(words[8 * kc + e, w]) for e in range(8)]
                x = [(e & 0xFFFFFFFF, e >> 32) for e in v]
                for m in range(4):
                    for r, (half, sel) in enumerate(
                            ((0, 0x5410), (0, 0x7632), (1, 0x5410),
                             (1, 0x7632))):
                        rows[r][m] = _byte_perm(x[2 * m][half],
                                                x[2 * m + 1][half], sel)
            else:
                u = [int(words[16 * kc + e, w]) for e in range(16)]
                for m in range(4):
                    c = _transpose4x4(*u[4 * m:4 * m + 4])
                    for r in range(4):
                        rows[r][m] = c[r]
            for r in range(4):
                row = 4 * w + r
                off = ((row // 64) * atoms * 64 * ATOM
                       + _sw128_offset(row % 64, 16 * kc, 64 * ATOM))
                img[off:off + 16] = np.array(rows[r], "<u4").view(np.uint8)
                writes[off:off + 16] += 1
    assert (writes == 1).all()
    return img


def _fetch_b_image(c8: np.ndarray, elem: int) -> np.ndarray:
    """One step's one-hot of a CTA's 8 carries, thread by thread: vector
    v = tid % 16 (+ 16) of column tid / 16; every byte written once."""
    img = np.zeros(256 * elem // ATOM * FETCH_N * ATOM, np.uint8)
    writes = np.zeros(img.size, np.int32)
    for tid in range(128):
        n = tid >> 4
        cc = int(c8[n])
        for h in range(elem):
            v = (tid & 15) + 16 * h
            w = [0, 0, 0, 0]
            if elem == 2 and cc >> 3 == v:
                w[(cc & 7) >> 1] = 0x3F80 << (16 * (cc & 1))
            if elem == 1 and cc >> 4 == v:
                w[(cc & 15) >> 2] = 1 << (8 * (cc & 3))
            off = _sw128_offset(n, 16 * v, FETCH_N * ATOM)
            img[off:off + 16] = np.array(w, "<u4").view(np.uint8)
            writes[off:off + 16] += 1
    assert (writes == 1).all()
    return img


def _fetch_desc_read(img, base: int, rows: int, ks: int, elem: int):
    """The (rows, 32 bytes) a wgmma k-step reads through sw128_desc(base)
    + 2 (ks % 4) after the atom offset, as float64 values."""
    r = np.arange(rows)[:, None]
    kb = np.arange(32)[None, :]
    addr = base + (r // 8) * 1024 + (r % 8) * ATOM + 32 * (ks % 4) + kb
    raw = img[addr ^ (((addr >> 7) & 7) << 4)]
    if elem == 1:
        return raw.view(np.int8).astype(np.float64)
    u16 = raw.copy().view("<u2").astype(np.uint32) << 16
    return u16.view(np.float32).astype(np.float64)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", probes.FETCH_BODIES)
def test_fetch_index_maps_rebuild_the_product(name, steps):
    """Every CTA's wgmma reads rebuild P^T (rows 316..319 zero) and the
    one-hot of its 8 carries, their product is P^T . onehot(c), and the
    column sums of rows 0..15 through the accumulator fragment and the
    shuffles give the plain version's next carries."""
    elem = 2 if "bf16" in name else 1
    k_steps = 256 * elem // 32
    atoms = 256 * elem // ATOM
    plane = probes.vpu_operand(name, CPU)
    plane_np = (plane.view(torch.int16).numpy() if elem == 2
                else plane.numpy())
    a_img = _fetch_a_image(plane_np, elem)
    pt = np.zeros((FETCH_ROWS, 256))
    per = 32 // elem                             # K elements a k-step
    for m in range(5):
        for ks in range(k_steps):
            base = m * atoms * 64 * ATOM + (ks // 4) * 64 * ATOM
            pt[64 * m:64 * m + 64, per * ks:per * ks + per] = \
                _fetch_desc_read(a_img, base, 64, ks, elem)
    want_pt = np.zeros((FETCH_ROWS, 256))
    want_pt[:316] = plane.float().numpy().T
    np.testing.assert_array_equal(pt, want_pt)
    c = probes.vpu_input(CPU).numpy().reshape(-1)
    for _ in range(steps):
        nxt = np.empty_like(c)
        for cta in range(1024 // FETCH_N):
            c8 = c[FETCH_N * cta:FETCH_N * cta + FETCH_N]
            b_img = _fetch_b_image(c8, elem)
            oh = np.zeros((FETCH_N, 256))
            for ks in range(k_steps):
                oh[:, per * ks:per * ks + per] = _fetch_desc_read(
                    b_img, (ks // 4) * FETCH_N * ATOM, FETCH_N, ks, elem)
            np.testing.assert_array_equal(oh, np.eye(256)[c8])
            d = pt @ oh.T                                  # (320, 8)
            lane = np.arange(32)
            frag = [d[lane // 4 + 8 * (e // 2), 2 * (lane % 4) + e % 2]
                    for e in range(4)]
            sums = np.stack([frag[0] + frag[2], frag[1] + frag[3]], 1)
            for o in (4, 8, 16):
                sums = sums + sums[lane ^ o]
            sums = sums[:4].reshape(-1).astype(np.int64)   # columns 0..7
            nxt[FETCH_N * cta:FETCH_N * cta + FETCH_N] = (
                (sums + (128 * 16 if elem == 1 else 0)) & 255)
        c = nxt
    want = probes.vpu_probe_plain(name, probes.vpu_input(CPU), steps, plane)
    np.testing.assert_array_equal(c.reshape(8, 128), want.numpy())


# ---------------------------------------------------------------------------
# The wrappers and the entry points without a card
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    x = probes.loop_input(CPU)
    with pytest.raises(ValueError, match="CUDA"):
        probes_cuda.loop_calib("chain_4", x, "chain", 4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        probes_cuda.vpu_probe("null_loop", x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        probes_cuda.i8_matmul(*probes.i8_matmul_inputs(CPU))


@pytest.mark.parametrize("module", ["loop_calib", "mosaic_probe",
                                    "vpu_probe"])
def test_entry_point_without_a_card_exits_1(module):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", f"mhc_tpu_torch.bench.{module}"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 1
    assert "torch.cuda.is_available() is false" in r.stderr
    assert r.stdout == ""
