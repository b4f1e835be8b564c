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
