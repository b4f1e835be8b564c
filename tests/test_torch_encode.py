"""K3 parity: mhc_tpu_torch's fused lookup+pack against the JAX package.

The port's CPU path is K3's plain version (the scatter-add form of
bitpack.encode_blocks); its words and bit counts must equal
bitpack.encode_blocks_merge and the Pallas fused kernel
(pack_blocks_fused_sm, interpret mode, default variant rankbf) exactly,
with masked tails and every code length 1..15 in play.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mhc_tpu.ops import bitpack, canonical
from mhc_tpu.ops.kernels import encode_pallas
from mhc_tpu_torch.models.entropy import tables_from_numpy
from mhc_tpu_torch.ops.kernels import encode_cuda


def _full_depth_case(seed: int, B: int, n: int):
    """Units over a 16-symbol alphabet whose code lengths are 1..15 (one
    symbol each, two at 15 — a complete code), assigned to the alphabet
    in a different order in every context; ragged n_valid."""
    rng = np.random.default_rng(seed)
    alphabet = rng.choice(256, 16, replace=False)
    lens = np.array(list(range(1, 16)) + [15])
    lengths = np.zeros((256, 256), np.int32)
    for c in range(256):
        lengths[c, alphabet] = rng.permutation(lens)
    units = alphabet[rng.integers(0, 16, (B, n))].astype(np.uint8)
    nv = np.full(B, n, np.int32)
    nv[1] = 0
    nv[2] = n // 3
    nv[-1] = 7
    units[np.arange(n)[None, :] >= nv[:, None]] = 0
    tables = {k: np.asarray(v) for k, v in
              canonical.canonical_codes(jnp.asarray(lengths)).items()}
    return units, nv, tables


def _port(units, nv, tables):
    t = tables_from_numpy(tables, "cpu")
    words, bits = encode_cuda.pack_units(
        torch.from_numpy(units), torch.from_numpy(nv), t["codes"],
        t["lengths"])
    return words.numpy().view(np.uint32), bits.numpy()


@pytest.mark.parametrize("seed,B,n", [(1, 9, 64), (2, 40, 333)])
def test_pack_matches_encode_blocks_merge(seed, B, n):
    units, nv, tables = _full_depth_case(seed, B, n)
    w_ref, b_ref = bitpack.encode_blocks_merge(
        jnp.asarray(units), jnp.asarray(nv), jnp.asarray(tables["codes"]),
        jnp.asarray(tables["lengths"]))
    words, bits = _port(units, nv, tables)
    assert words.shape == (B, bitpack.words_for_block(n))
    np.testing.assert_array_equal(bits, np.asarray(b_ref))
    np.testing.assert_array_equal(words, np.asarray(w_ref))
    # every code length is used by some coded symbol
    prev = np.concatenate([np.zeros((B, 1), np.int64), units[:, :-1]], 1)
    used = tables["lengths"][prev, units][np.arange(n)[None, :] < nv[:, None]]
    assert set(used.tolist()) == set(range(1, 16))


def test_pack_matches_pallas_fused_interpret():
    units, nv, tables = _full_depth_case(3, 37, 300)
    w_ref, b_ref = encode_pallas.pack_blocks_fused_sm(
        jnp.asarray(np.ascontiguousarray(units.T)), jnp.asarray(nv),
        {k: jnp.asarray(v) for k, v in tables.items()},
        interpret=True, variant="rankbf")
    words, bits = _port(units, nv, tables)
    np.testing.assert_array_equal(bits, np.asarray(b_ref))
    np.testing.assert_array_equal(words, np.asarray(w_ref))


def test_pack_wrapper_checks_inputs():
    units = torch.zeros((2, 8), dtype=torch.uint8)
    nv = torch.full((2,), 8, dtype=torch.int32)
    tab = torch.zeros((256, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        encode_cuda.pack_units(units, nv, tab[:16], tab)
    with pytest.raises(ValueError):
        encode_cuda.pack_units(units[:, ::2], nv, tab, tab)
