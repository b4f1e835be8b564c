"""The bubble-stream packer (K6) and its two compactions against the JAX
package, tolerance 0.

On the CPU `bubble_pack` runs its plain version. It equals the Pallas
kernel's launcher `_run_bubble_pack` (interpret mode) on all four
outputs, cut to the first R rows and ceil(n/2) rounds, including the
word slots of rounds that complete no word, and `pack_tile_reference`
on one tile;
`compact_bubbles` equals `pack_blocks_pallas` and `bubbles_to_payload`
equals `pack_blocks_to_payload` (both interpret mode); and the compacted
bubble stream equals K3's words for both modes. K15's wrappers
(`stages_cuda.compact_bubbles`, `bubbles_to_payload`) take those plain
versions on CPU tensors and refuse what their kernels do not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhc_tpu.ops.kernels import encode_pallas
from mhc_tpu_torch.models.entropy import tables_from_numpy
from mhc_tpu_torch.ops import bitpack
from mhc_tpu_torch.ops.kernels import encode_cuda, stages_cuda
from tests.test_torch_dense import _case

SHAPES = [(1024, 64), (200, 333), (64, 512)]


def _units(mode: str, R: int, n: int, seed: int):
    """_case's units with a row of n_valid 0 (row 1) and a one-symbol
    unit (row 2), as torch tensors with the model's tables."""
    units, nv, tables = _case(mode, R, n, seed)
    nv[2] = 1
    t = tables_from_numpy(tables, "cpu")
    return torch.from_numpy(units), torch.from_numpy(nv), t


def _cl(R: int, n: int, seed: int = 0, mode: str = "markov"):
    u, nv, t = _units(mode, R, n, seed)
    return encode_cuda.lookup_cl(u, nv, t["codes"], t["lengths"])


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("R,n", SHAPES)
def test_bubble_pack_matches_pallas_interpret(R, n):
    cl = _cl(R, n, seed=n)
    bw, bv, tail, bits = encode_cuda.bubble_pack(cl)
    rounds = (n + 1) // 2
    assert bw.shape == bv.shape == (R, rounds) and bv.dtype == torch.uint8
    rbw, rbv, rtail, rbits, _ = encode_pallas._run_bubble_pack(
        jnp.asarray(_u32(cl)), interpret=True)
    ref_bv = np.asarray(rbv)[:R, :rounds]
    np.testing.assert_array_equal(bv.numpy(), ref_bv)
    # every slot, also those of rounds that complete no word
    np.testing.assert_array_equal(_u32(bw), np.asarray(rbw)[:R, :rounds])
    np.testing.assert_array_equal(_u32(tail), np.asarray(rtail)[:R])
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rbits)[:R])
    assert 0 < ref_bv.sum() < ref_bv.size
    assert bits[1] == 0 and 0 < bits[2] <= 15


def test_bubble_pack_matches_tile_reference():
    R, n = 1024, 64
    cl = _u32(_cl(R, n, seed=7)).astype(np.int64)
    codes = jnp.asarray((cl & 0xFFFF).T.reshape(n, 8, 128).astype(np.uint32))
    lens = jnp.asarray((cl >> 16).T.reshape(n, 8, 128).astype(np.int32))
    words, valids, a0, tot = encode_pallas.pack_tile_reference(codes, lens)
    bw, bv, tail, bits = encode_cuda.bubble_pack(_cl(R, n, seed=7))
    np.testing.assert_array_equal(
        _u32(bw), np.asarray(words).reshape(n // 2, R).T)
    np.testing.assert_array_equal(
        bv.numpy(), np.asarray(valids).reshape(n // 2, R).T)
    np.testing.assert_array_equal(_u32(tail), np.asarray(a0).reshape(R))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(tot).reshape(R))


@pytest.mark.parametrize("R,n", SHAPES)
def test_compact_bubbles_matches_pack_blocks_pallas(R, n):
    cl = _cl(R, n, seed=n + 1)
    ref_words, ref_bits = encode_pallas.pack_blocks_pallas(
        jnp.asarray(_u32(cl)), interpret=True)
    bw, bv, tail, bits = encode_cuda.bubble_pack(cl)
    words = bitpack.compact_bubbles(bw, bv, tail, bits,
                                    bitpack.words_for_block(n))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_bits))
    np.testing.assert_array_equal(_u32(words), np.asarray(ref_words))


@pytest.mark.parametrize("R,n", SHAPES)
def test_bubbles_to_payload_matches_reference(R, n):
    cl = _cl(R, n, seed=n + 2)
    ref_payload, ref_bits = encode_pallas.pack_blocks_to_payload(
        jnp.asarray(_u32(cl)), interpret=True)
    ref_payload = np.asarray(ref_payload)
    payload = bitpack.bubbles_to_payload(*encode_cuda.bubble_pack(cl))
    total = int(((np.asarray(ref_bits).astype(np.int64) + 31) // 32).sum())
    got = _u32(payload)
    np.testing.assert_array_equal(got[:total], ref_payload[:total])
    assert not ref_payload[total:].any() and not got[total:].any()


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_compacted_bubbles_equal_pack_units(mode):
    u, nv, t = _units(mode, 48, 333, 5)
    tab = (t["codes"], t["lengths"])
    bubbles = encode_cuda.bubble_pack(encode_cuda.lookup_cl(u, nv, *tab))
    words = bitpack.compact_bubbles(*bubbles, bitpack.words_for_block(333))
    ref_words, ref_bits = encode_cuda.pack_units(u, nv, *tab)
    assert torch.equal(words, ref_words)
    assert torch.equal(bubbles[3], ref_bits)


# ---------------------------------------------------------------------------
# K15's wrappers (`stages_cuda.compact_bubbles`, `bubbles_to_payload`):
# on CPU tensors their plain versions above, and the arguments the kernels
# take
# ---------------------------------------------------------------------------

def _bubbles(R: int = 12, n: int = 64, seed: int = 3):
    """K6's outputs for _units' batch: row 1 has n_valid 0, row 2 one
    symbol (a tail and no valid slot)."""
    return encode_cuda.bubble_pack(_cl(R, n, seed))


@pytest.mark.parametrize("R,n", SHAPES)
def test_k15_wrappers_match_the_reference(R, n):
    """The wrappers, on the CPU, equal pack_blocks_pallas' rows and
    pack_blocks_to_payload's streams (interpret mode), a unit of n_valid
    0 and one of a single symbol included."""
    cl = _cl(R, n, seed=n + 3)
    bubbles = encode_cuda.bubble_pack(cl)
    assert int(bubbles[3][1]) == 0 and not bubbles[1][1].any()
    assert 0 < int(bubbles[3][2]) < 32 and not bubbles[1][2].any()
    ref_words, ref_bits = encode_pallas.pack_blocks_pallas(
        jnp.asarray(_u32(cl)), interpret=True)
    words = stages_cuda.compact_bubbles(*bubbles, bitpack.words_for_block(n))
    np.testing.assert_array_equal(_u32(words), np.asarray(ref_words))
    ref_payload, _ = encode_pallas.pack_blocks_to_payload(
        jnp.asarray(_u32(cl)), interpret=True)
    total = int(((np.asarray(ref_bits).astype(np.int64) + 31) // 32).sum())
    payload = stages_cuda.bubbles_to_payload(*bubbles)
    assert payload.shape == (R * ((n + 1) // 2 + 1),)
    np.testing.assert_array_equal(_u32(payload)[:total],
                                  np.asarray(ref_payload)[:total])


def test_k15_wrappers_take_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors each wrapper returns its plain version's result,
    and only because the tensors lie on the CPU."""
    calls = []
    for name in ("compact_bubbles", "bubbles_to_payload"):
        real = getattr(bitpack, name)
        monkeypatch.setattr(bitpack, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    bubbles = _bubbles()
    rows = stages_cuda.compact_bubbles(*bubbles, 7)
    payload = stages_cuda.bubbles_to_payload(*bubbles)
    assert calls == ["compact_bubbles", "bubbles_to_payload"]
    assert rows.dtype == payload.dtype == torch.int32
    assert rows.shape == (12, 7)


@pytest.mark.parametrize("bad", ["bw_dtype", "bv_dtype", "bv_shape",
                                 "tail_shape", "bits_dtype", "bw_view",
                                 "bw_rank", "width"])
def test_k15_wrappers_refuse_what_their_kernels_do_not_take(bad):
    bw, bv, tail, bits = _bubbles()
    args = {"bw_dtype": (bw.long(), bv, tail, bits),
            "bv_dtype": (bw, bv.bool(), tail, bits),
            "bv_shape": (bw, bv[:, :-1].contiguous(), tail, bits),
            "tail_shape": (bw, bv, tail[:-1], bits),
            "bits_dtype": (bw, bv, tail, bits.long()),
            "bw_view": (bw.t().contiguous().t(), bv, tail, bits),
            "bw_rank": (bw.reshape(-1), bv, tail, bits),
            "width": (bw, bv, tail, bits)}[bad]
    with pytest.raises(ValueError):
        stages_cuda.compact_bubbles(*args, -1 if bad == "width" else 9)
    if bad != "width":
        with pytest.raises(ValueError):
            stages_cuda.bubbles_to_payload(*args)


def test_k15_wrappers_of_no_units():
    empty = (torch.zeros((0, 32), dtype=torch.int32),
             torch.zeros((0, 32), dtype=torch.uint8),
             torch.zeros(0, dtype=torch.int32),
             torch.zeros(0, dtype=torch.int32))
    assert stages_cuda.compact_bubbles(*empty, 9).shape == (0, 9)
    assert stages_cuda.bubbles_to_payload(*empty).shape == (0,)
