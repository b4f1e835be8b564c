"""K7 parity: mhc_tpu_torch's Markov decode against the JAX package.

The port's CPU path is K7's plain version; its rows must equal
bitpack.decode_blocks (zeros past n_valid, every code length 1..15 in
play) and one tiny run of the Pallas kernel decode_blocks_pallas
(interpret mode, fetch mxu4) exactly.
"""

import numpy as np
import torch
import jax.numpy as jnp

from mhc_tpu.ops import bitpack, canonical, histogram, huffman
from mhc_tpu.ops.kernels import decode_pallas
from mhc_tpu_torch.models.entropy import tables_from_numpy
from mhc_tpu_torch.ops.kernels import decode_cuda


def _full_depth_case(seed: int, B: int, n: int):
    """16-symbol alphabet with code lengths 1..15 (two at 15) in a
    different order per context; ragged n_valid."""
    rng = np.random.default_rng(seed)
    alphabet = rng.choice(256, 16, replace=False)
    lens = np.array(list(range(1, 16)) + [15])
    lengths = np.zeros((256, 256), np.int32)
    for c in range(256):
        lengths[c, alphabet] = rng.permutation(lens)
    units = alphabet[rng.integers(0, 16, (B, n))].astype(np.uint8)
    nv = np.full(B, n, np.int32)
    nv[0] = 0
    nv[3] = n // 2 + 1
    nv[-1] = 5
    units[np.arange(n)[None, :] >= nv[:, None]] = 0
    tables = {k: np.asarray(v) for k, v in
              canonical.canonical_codes(jnp.asarray(lengths)).items()}
    return units, nv, tables


def _port_decode(words, nv, tables, n_out):
    t = tables_from_numpy(tables, "cpu")
    out = decode_cuda.decode_units(
        torch.from_numpy(np.array(words, np.uint32).view(np.int32)),
        torch.from_numpy(nv), t["lim"], t["base"], t["first_code"],
        t["sorted_syms"], n_out=n_out)
    return out.numpy()


def test_decode_matches_decode_blocks():
    B, n = 24, 200
    units, nv, tables = _full_depth_case(5, B, n)
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    words, _ = bitpack.encode_blocks_merge(
        jnp.asarray(units), jnp.asarray(nv), jt["codes"], jt["lengths"])
    words = np.asarray(words)
    ref = np.asarray(bitpack.decode_blocks(
        jnp.asarray(words), jnp.asarray(nv), jt["lim"], jt["base"],
        jt["first_code"], jt["sorted_syms"], n_out=n))
    got = _port_decode(words, nv, tables, n)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, units)


def test_decode_guards_reads_past_stream_width():
    """Streams cut to their used words (no slack word) still decode:
    reads at index >= W are zeros."""
    B, n = 12, 96
    units, nv, tables = _full_depth_case(6, B, n)
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    words, bits = bitpack.encode_blocks_merge(
        jnp.asarray(units), jnp.asarray(nv), jt["codes"], jt["lengths"])
    W = int((np.asarray(bits).max() + 31) // 32)
    got = _port_decode(np.asarray(words)[:, :W], nv, tables, n)
    np.testing.assert_array_equal(got, units)


def test_decode_matches_pallas_interpret():
    """The tiny interpret-mode shape of tests/test_decode_pallas.py."""
    rng = np.random.default_rng(11)
    n, R = 16, 1024
    blocks = rng.integers(40, 120, (R, n), dtype=np.uint8)
    nv = np.full(R, n, np.int32)
    counts = histogram.histogram_markov(jnp.asarray(blocks), jnp.asarray(nv),
                                        method="scatter")
    lx = huffman.code_lengths(jnp.asarray(huffman.rescale_counts(
        np.asarray(counts))))
    jt = canonical.canonical_codes(lx)
    words, _ = bitpack.encode_blocks_merge(
        jnp.asarray(blocks), jnp.asarray(nv), jt["codes"], jt["lengths"])
    ref = np.asarray(decode_pallas.decode_blocks_pallas(
        words, jt["lim"], jt["base"], jt["first_code"], jt["sorted_syms"],
        n_out=n, markov=True, interpret=True, out_chunk=16,
        fetch_impl="mxu4"))
    got = _port_decode(np.asarray(words), nv,
                       {k: np.asarray(v) for k, v in jt.items()}, n)
    np.testing.assert_array_equal(got, ref[:R, :n])
    np.testing.assert_array_equal(got, blocks)
