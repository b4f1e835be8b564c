"""Split encode parity: mhc_tpu_torch's cl-plane lookup (K5) and pack
(K4) against the JAX package, and `pack_method` end to end.

On the CPU the kernels' plain versions run: K5 equals api.lookup_cl and
the Pallas lookup kernel (interpret mode), K4 equals the Pallas dense
packer (interpret mode), and K5 then K4 equals K3 and the reference's
merge packer. `compress(pack_method="dense")` and
`compress(pack_method="pallas")` (K5 then the bubble-stream packer K6;
tests/test_torch_bubble.py holds K6 itself) write the fused path's
container, which is the JAX package's. Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import mhc_tpu_torch
from mhc_tpu import api as jax_api
from mhc_tpu.models.entropy import get_model as jax_model
from mhc_tpu.ops import bitpack as jax_bitpack
from mhc_tpu.ops.kernels import encode_pallas, lookup_pallas
from mhc_tpu_torch import engine
from mhc_tpu_torch.models.entropy import tables_from_numpy
from mhc_tpu_torch.ops.kernels import encode_cuda
from tests.corpus import english_like, mixed_binary
from tests.torch_fixtures import one_torch_thread  # noqa: F401


def _case(mode: str, B: int, n: int, seed: int):
    """Skewed units with ragged n_valid and the model's tables (numpy),
    built by the JAX package."""
    rng = np.random.default_rng(seed)
    units = rng.integers(0, 256, (B, n), dtype=np.uint8)
    units[units < 190] %= 37
    nv = rng.integers(1, n + 1, B).astype(np.int32)
    nv[0] = n
    nv[1] = 0
    m = jax_model(mode)
    counts = m.histogram(jnp.asarray(units), jnp.asarray(nv),
                         method="scatter")
    t = m.tables_from_lengths(m.lengths_from_counts(np.asarray(counts)))
    return units, nv, {k: np.asarray(v) for k, v in t.items()}


def _port_cl(units, nv, tables):
    t = tables_from_numpy(tables, "cpu")
    return encode_cuda.lookup_cl(torch.from_numpy(units),
                                 torch.from_numpy(nv), t["codes"],
                                 t["lengths"])


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_lookup_matches_api_lookup_cl(mode):
    units, nv, tables = _case(mode, 40, 333, 1)
    ref = np.asarray(jax_api.lookup_cl(
        jnp.asarray(units), jnp.asarray(nv),
        {k: jnp.asarray(v) for k, v in tables.items()}))
    got = _port_cl(units, nv, tables)
    assert got.dtype == torch.int32 and got.shape == units.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_lookup_matches_pallas_interpret():
    units, nv, tables = _case("markov", 8, 64, 2)
    ref = np.asarray(lookup_pallas.lookup_cl_sm_pallas(
        jnp.asarray(np.ascontiguousarray(units.T)), jnp.asarray(nv),
        {k: jnp.asarray(v) for k, v in tables.items()}, interpret=True)).T
    got = _port_cl(units, nv, tables)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_pack_matches_pallas_dense_interpret():
    units, nv, tables = _case("markov", 8, 64, 3)
    cl = _port_cl(units, nv, tables)
    w_ref, b_ref = encode_pallas.pack_blocks_dense(
        jnp.asarray(cl.numpy().view(np.uint32)), interpret=True)
    words, bits = encode_cuda.pack_cl(cl)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(b_ref))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(w_ref))


@pytest.mark.parametrize("mode,B,n", [("markov", 9, 64),
                                      ("markov", 40, 333),
                                      ("huffman", 17, 1024)])
def test_lookup_then_pack_equals_fused_and_merge(mode, B, n):
    units, nv, tables = _case(mode, B, n, B)
    t = tables_from_numpy(tables, "cpu")
    u, v = torch.from_numpy(units), torch.from_numpy(nv)
    w_split, b_split = encode_cuda.pack_cl(
        encode_cuda.lookup_cl(u, v, t["codes"], t["lengths"]))
    w_fused, b_fused = encode_cuda.pack_units(u, v, t["codes"], t["lengths"])
    w_ref, b_ref = jax_bitpack.encode_blocks_merge(
        jnp.asarray(units), jnp.asarray(nv), jnp.asarray(tables["codes"]),
        jnp.asarray(tables["lengths"]))
    assert torch.equal(w_split, w_fused) and torch.equal(b_split, b_fused)
    np.testing.assert_array_equal(b_split.numpy(), np.asarray(b_ref))
    np.testing.assert_array_equal(w_split.numpy().view(np.uint32),
                                  np.asarray(w_ref))


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("data", [english_like(120_000, seed=4),
                                  mixed_binary(90_000, seed=5), b"Q"],
                         ids=["english", "mixed", "one_byte"])
def test_dense_container_equals_fused_and_jax(mode, data):
    dense = mhc_tpu_torch.compress(data, mode=mode, device="cpu",
                                   pack_method="dense")
    assert dense == mhc_tpu_torch.compress(data, mode=mode, device="cpu")
    assert dense == jax_api.compress(data, mode=mode)
    assert mhc_tpu_torch.decompress(dense, device="cpu") == data


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("block_size,decode_unit", [(65536, 8192),
                                                   (4096, 4096)],
                         ids=["units_8k", "units_eq_blocks"])
@pytest.mark.parametrize("data", [english_like(120_000, seed=4),
                                  mixed_binary(90_000, seed=5), b"Q"],
                         ids=["english", "mixed", "one_byte"])
def test_pallas_container_equals_jax(mode, block_size, decode_unit, data):
    """K5 then K6: with decode_unit == block_size a Markov encode takes
    the bubble stream straight to the payload (the reference's
    pack_blocks_to_payload); otherwise it compacts it to words first."""
    blob = mhc_tpu_torch.compress(data, mode=mode, device="cpu",
                                  block_size=block_size,
                                  decode_unit=decode_unit,
                                  pack_method="pallas")
    assert blob == jax_api.compress(data, mode=mode, block_size=block_size,
                                    decode_unit=decode_unit)
    assert mhc_tpu_torch.decompress(blob, device="cpu") == data


@pytest.mark.parametrize("pack_method", ["merge", "scatter", "bubble"])
def test_rejected_pack_method_raises(pack_method):
    st = engine.stage(b"abcabc", device="cpu")
    match = {"merge": "Do not port", "scatter": "Do not port",
             "bubble": "unknown"}[pack_method]
    with pytest.raises(ValueError, match=match):
        engine.encode(st, pack_method=pack_method)
    with pytest.raises(ValueError, match=match):
        mhc_tpu_torch.compress(b"abcabc", device="cpu",
                               pack_method=pack_method)


def test_pack_cl_wrapper_checks_inputs():
    with pytest.raises(ValueError):
        encode_cuda.pack_cl(torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        encode_cuda.pack_cl(torch.zeros((2, 8), dtype=torch.int32)[:, ::2])
