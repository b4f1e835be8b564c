"""The tile packer of K4 and K6 (csrc/encode.cu::pack_tiles_kernel),
replayed in plain torch, against the kernels' plain versions and the JAX
package, tolerance 0.

The CUDA kernel runs only on the card. `replay` below walks a cl plane
as the kernel does, a warp per unit and a tile of 128 symbols at a time:
each lane joins its 4 codes, a scan over the 32 lanes plus the bits
pending from the tile before gives its bit offset, its bits are ORed
into at most 3 of the tile's staged stream words (three staging buffers
in turn, lane 0 bringing the pending bits along), the whole words go to
the unit's row (K4), each lane's two bubble slots are read back from the
staged words (K6), and the pending bits pass to the next tile. It must
equal `pack_cl_plain` and `bubble_pack_plain`, which the other test
files hold to the Pallas kernels; two cases here run those directly
(interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhc_tpu.ops.kernels import encode_pallas
from mhc_tpu_torch.ops import bitpack
from mhc_tpu_torch.ops.kernels import encode_cuda

TILE = 128
STAGE_WORDS = 64
M32 = 0xFFFFFFFF


def _lsr(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by k in [1, 63]."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def replay(cl: torch.Tensor):
    """(R, n) int32 cl plane -> (words, bits, bw, bv, tail) as K4 and K6
    write them; every row is one warp, vectorised over rows and lanes."""
    R, n = cl.shape
    W = bitpack.words_for_block(n)
    rounds = (n + 1) // 2
    tiles = -(-n // TILE)
    c = torch.zeros((R, tiles * TILE), dtype=torch.long)
    c[:, :n] = cl.long() & M32                # past n: zero-length codes
    c = c.reshape(R, tiles, 32, 4)
    words = torch.zeros((R, W + STAGE_WORDS), dtype=torch.long)
    bw = torch.zeros((R, tiles * 64), dtype=torch.long)
    bv = torch.zeros((R, tiles * 64), dtype=torch.long)
    # + 2: a lane's second and third word, written as 0 when unused
    stage = [torch.zeros((R, STAGE_WORDS + 2), dtype=torch.long)
             for _ in range(3)]
    wbase = torch.zeros(R, dtype=torch.long)
    carry = torch.zeros(R, dtype=torch.long)
    pend = torch.zeros(R, dtype=torch.long)
    total = torch.zeros(R, dtype=torch.long)
    k64 = torch.arange(STAGE_WORDS)
    for t in range(tiles):
        x_, y_, z_, w_ = c[:, t].unbind(-1)
        la = (x_ >> 16) + (y_ >> 16)
        lb = (z_ >> 16) + (w_ >> 16)
        pa = ((x_ & 0xFFFF) << (y_ >> 16)) | (y_ & 0xFFFF)
        pb = ((z_ & 0xFFFF) << (w_ >> 16)) | (w_ & 0xFFFF)
        ln = la + lb
        incl = torch.cumsum(ln, dim=1)                    # the warp scan
        tile_bits = incl[:, -1]
        off = carry[:, None] + incl - ln
        cur = stage[t % 3]
        # the lane's bits MSB-aligned in 64, then at bit off & 31 of 3 words
        x = torch.where(ln > 0,
                        ((pa << lb) | pb) << (64 - ln).clamp(max=63), 0)
        s = off & 31
        wi = off >> 5
        w0 = _lsr(x, 32 + s)
        w0[:, 0] |= pend                                  # lane 0
        w1 = torch.where(s + ln > 32, (x >> s) & M32, 0)
        w2 = torch.where(s + ln > 64, (x << (32 - s)) & M32, 0)
        # disjoint bit ranges: add equals or
        cur.scatter_add_(1, wi, w0)
        cur.scatter_add_(1, wi + 1, w1)
        cur.scatter_add_(1, wi + 2, w2)
        end = carry + tile_bits
        nw = end >> 5
        assert int(nw.max()) <= 60
        pend = cur.gather(1, nw[:, None])[:, 0]
        # K6: each lane's two slots, read back from the staged words
        mid = off + la
        last = mid + lb
        va = (mid >> 5) > (off >> 5)
        vb = (last >> 5) > (mid >> 5)

        def cut(word, k):
            return word & ~(M32 >> k) & M32

        sa = torch.where(va, cur.gather(1, off >> 5),
                         cut(cur.gather(1, mid >> 5), mid & 31))
        sb = torch.where(vb, cur.gather(1, mid >> 5),
                         cut(cur.gather(1, last >> 5), last & 31))
        bw[:, t * 64: (t + 1) * 64] = torch.stack([sa, sb], -1).reshape(R, 64)
        bv[:, t * 64: (t + 1) * 64] = torch.stack([va, vb], -1).reshape(R, 64)
        # K4: the whole words leave, lane l taking words l and l + 32
        keep = k64[None, :] < nw[:, None]
        words.scatter_(1, torch.where(keep, wbase[:, None] + k64, W + 63),
                       torch.where(keep, cur[:, :STAGE_WORDS], 0))
        stage[(t + 2) % 3].zero_()             # the tile before's buffer
        wbase = wbase + nw
        carry = end & 31
        total = total + tile_bits
    words.scatter_(1, torch.where(carry > 0, wbase, W + 63)[:, None],
                   pend[:, None])
    to_i32 = encode_cuda._to_i32
    return (to_i32(words[:, :W]), total.to(torch.int32),
            to_i32(bw[:, :rounds]), bv[:, :rounds].to(torch.uint8),
            to_i32(pend))


def _plane(kind: str, R: int, n: int, seed: int) -> torch.Tensor:
    """A cl plane with valid codes (code < 2**len): "random" lengths in
    0..15 (zero-length codes inside tiles), "short" in 0..3, "all15",
    "zeros", or "striped" (rows of zeros between full rows, ragged
    n_valid on the others)."""
    rng = np.random.default_rng(seed)
    hi = {"random": 16, "short": 4, "striped": 16}.get(kind)
    if kind == "all15":
        lens = np.full((R, n), 15, np.int64)
    elif kind == "zeros":
        lens = np.zeros((R, n), np.int64)
    else:
        lens = rng.integers(0, hi, (R, n)).astype(np.int64)
    if kind == "striped":
        nv = rng.integers(0, n + 1, R)
        nv[::2] = 0
        nv[-1] = n
        lens[np.arange(n)[None, :] >= nv[:, None]] = 0
    codes = rng.integers(0, 1 << 15, (R, n)) & ((1 << lens) - 1)
    return torch.from_numpy(((lens << 16) | codes).astype(np.int32))


def _assert_replay_equals_plain(cl):
    words, bits, bw, bv, tail = replay(cl)
    ref_words, ref_bits = encode_cuda.pack_cl_plain(cl)
    assert torch.equal(bits, ref_bits)
    assert torch.equal(words, ref_words)
    for got, ref in zip((bw, bv, tail, bits),
                        encode_cuda.bubble_pack_plain(cl), strict=True):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    compact = bitpack.compact_bubbles(bw, bv, tail, bits, words.shape[1])
    assert torch.equal(compact, ref_words)


@pytest.mark.parametrize("kind", ["random", "short", "all15", "zeros",
                                  "striped"])
@pytest.mark.parametrize("R,n", [(5, 128), (3, 1024), (7, 333), (4, 131),
                                 (2, 4), (1, 12), (3, 510), (2, 1)])
def test_replay_equals_plain_versions(kind, R, n):
    """n on and off the tile (128) and the lane (4), odd n (K6's last
    round takes a zero-length second code), one unit, n below a tile."""
    _assert_replay_equals_plain(_plane(kind, R, n, R * n))


def test_replay_on_a_long_unit():
    """8 KB units: 64 tiles, the word index and the pending bits carried
    through all of them."""
    _assert_replay_equals_plain(_plane("random", 2, 8192, 1))
    _assert_replay_equals_plain(_plane("all15", 1, 8192, 2))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("kind,R,n", [("random", 6, 300),
                                      ("all15", 3, 131)])
def test_replay_equals_pallas_dense_interpret(kind, R, n):
    cl = _plane(kind, R, n, n)
    words, bits, *_ = replay(cl)
    w_ref, b_ref = encode_pallas.pack_blocks_dense(
        jnp.asarray(_u32(cl)), interpret=True)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(b_ref))
    np.testing.assert_array_equal(_u32(words), np.asarray(w_ref))


@pytest.mark.parametrize("kind,R,n", [("random", 6, 300),
                                      ("striped", 5, 131)])
def test_replay_equals_pallas_bubble_interpret(kind, R, n):
    cl = _plane(kind, R, n, n + 1)
    _, bits, bw, bv, tail = replay(cl)
    rounds = (n + 1) // 2
    rbw, rbv, rtail, rbits, _ = encode_pallas._run_bubble_pack(
        jnp.asarray(_u32(cl)), interpret=True)
    np.testing.assert_array_equal(bv.numpy(), np.asarray(rbv)[:R, :rounds])
    np.testing.assert_array_equal(_u32(bw), np.asarray(rbw)[:R, :rounds])
    np.testing.assert_array_equal(_u32(tail), np.asarray(rtail)[:R])
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rbits)[:R])


def test_bubble_planes_are_contiguous():
    """K6's planes are unit-major: the compactions' cumsum(dim=1) and
    scatters run on contiguous rows."""
    bw, bv, _, _ = encode_cuda.bubble_pack(_plane("random", 5, 300, 0))
    assert bw.is_contiguous() and bv.is_contiguous()
    assert bw.shape == bv.shape == (5, 150)
