"""The fused table build (K11 and K13 in one launch on a card) against the
JAX package on the CPU, tolerance 0.

`huffman_cuda.code_tables_plain`, what `code_tables` runs on a CPU
tensor, must give the lengths of `mhc_tpu.ops.huffman.code_lengths` and
the tables of `mhc_tpu.ops.canonical.canonical_codes` of those lengths,
row for row: Markov (256, 256) counts, and order-0 (256,) counts whose
tables repeat over the 256 contexts. The JAX build takes counts already
rescaled to row totals below 2**28 (its docstring); they go through the
reference's host `rescale_counts`, which holds int64 totals of 2**32 and
more, and equals `rescale_counts_jax` where both apply. Then
`EntropyModel.tables_for` on the CPU equals `lengths_for` followed by
`tables_from_lengths`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhc_tpu.ops import canonical as jax_canonical
from mhc_tpu.ops import huffman as jax_huffman
from mhc_tpu_torch.models.entropy import get_model
from mhc_tpu_torch.ops import canonical
from mhc_tpu_torch.ops.kernels import huffman_cuda


def _fib() -> np.ndarray:
    """Fibonacci counts: code lengths far past 15, the length limit's
    case."""
    f = np.zeros(256, np.int64)
    a, b = 1, 1
    for i in range(256):
        f[i], (a, b) = a, (b, min(a + b, 1 << 40))
    return f


def _random(seed: int, rows: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 10 ** int(rng.integers(2, 7)), (rows, 256))
            * (rng.random((rows, 256)) < rng.random((rows, 1))))


def _markov(seed: int, **rows) -> np.ndarray:
    """256 random rows of counts with the named rows replaced."""
    c = _random(seed, 256)
    for i, row in rows.items():
        c[int(i[1:])] = row
    return c


def _one_symbol() -> np.ndarray:
    c = np.zeros(256, np.int64)
    c[77] = 12345
    return c


CASES = {
    "markov_seed_1": lambda: _markov(1),
    "markov_seed_2": lambda: _markov(2),
    "order0_seed_1": lambda: _random(1, 1),
    "order0_seed_2": lambda: _random(2, 1),
    "markov_all_zero_row": lambda: _markov(3, r0=0, r200=0),
    "order0_all_zero": lambda: np.zeros((1, 256), np.int64),
    "markov_one_symbol_row": lambda: _markov(4, r5=_one_symbol()),
    "order0_one_symbol": lambda: _one_symbol()[None],
    "markov_fibonacci": lambda: _markov(
        5, r0=_fib(), r1=np.random.default_rng(5).permutation(_fib()),
        r255=np.where(np.arange(256) < 40, _fib(), 0)),
    "order0_fibonacci": lambda: _fib()[None],
    "markov_totals_over_2_32": lambda: _markov(
        6, r0=_random(60, 1)[0] << 30, r9=(_fib() << 8),
        r100=np.full(256, 1 << 26, np.int64)),
    "order0_total_over_2_32": lambda: (_random(7, 1) + 1) << 32,
}


def _jax_tables(counts: np.ndarray):
    """(lengths, tables) of the JAX package: `code_lengths` of the
    rescaled counts, padded to 256 rows so that every case shares one
    compiled shape, then `canonical_codes` of each case's lengths (an
    order-0 row's tables repeated over 256 rows)."""
    rows = counts.shape[0]
    padded = np.zeros((256, 256), np.int32)
    padded[:rows] = jax_huffman.rescale_counts(counts)
    lengths = np.asarray(jax_huffman.code_lengths(jnp.asarray(padded)))[:rows]
    t = jax_canonical.canonical_codes(jnp.asarray(lengths if rows > 1
                                                  else lengths[0]))
    return lengths, {k: np.broadcast_to(np.asarray(v).astype(np.int64),
                                        (256, np.asarray(v).shape[-1]))
                     for k, v in t.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_code_tables_plain_equals_jax(case):
    counts = CASES[case]()
    ref_lengths, ref = _jax_tables(counts)
    for dtype in (torch.int64, torch.int32):
        if dtype == torch.int32 and counts.max() >= 2 ** 31:
            continue
        lengths, tables = huffman_cuda.code_tables_plain(
            torch.from_numpy(counts).to(dtype), 256)
        assert lengths.dtype == torch.uint8
        assert lengths.shape == counts.shape
        np.testing.assert_array_equal(lengths.numpy(), ref_lengths)
        assert set(tables) == set(ref)
        for k, v in tables.items():
            assert v.dtype == torch.int32 and v.is_contiguous(), k
            np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_cases_cover_the_corners():
    """The cases hold what they are named for: rows longer than 15 bits
    before the limit, and int64 totals of 2**32 and more."""
    for case in ("markov_fibonacci", "order0_fibonacci"):
        unlimited = np.stack([jax_huffman.code_lengths_np(
            r, max_len=64) for r in CASES[case]()])
        assert unlimited.max() > 15, case
    for case in ("markov_totals_over_2_32", "order0_total_over_2_32"):
        assert CASES[case]().sum(axis=1).max() >= 2 ** 32, case


@pytest.mark.parametrize("mode", ["markov", "huffman"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_tables_for_equals_lengths_then_tables(mode, dtype):
    model = get_model(mode)
    counts = _random(11, 256 if model.markov else 1)
    counts = torch.from_numpy(counts.reshape(
        (256, 256) if model.markov else (256,))).to(dtype)
    lengths, tables = model.tables_for(counts, "cpu")
    ref_lengths = model.lengths_for(counts)
    ref = model.tables_from_lengths(ref_lengths, "cpu")
    assert lengths.dtype == torch.uint8 and lengths.shape == counts.shape
    assert torch.equal(lengths, ref_lengths)
    assert set(tables) == set(ref)
    for k in ref:
        assert torch.equal(tables[k], ref[k]), k


def test_code_tables_takes_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors `code_tables` returns its plain version's result,
    and only because the counts lie on the CPU."""
    calls = []
    real = huffman_cuda.code_tables_plain
    monkeypatch.setattr(huffman_cuda, "code_tables_plain",
                        lambda *a: calls.append(a) or real(*a))
    counts = torch.from_numpy(_random(12, 1))
    lengths, tables = huffman_cuda.code_tables(counts, 256)
    assert len(calls) == 1
    ref_lengths, ref = real(counts, 256)
    assert torch.equal(lengths, ref_lengths)
    assert all(torch.equal(tables[k], ref[k]) for k in ref)
    assert torch.equal(tables["codes"], canonical.canonical_tables_plain(
        lengths, 256)["codes"])


@pytest.mark.parametrize("bad", ["rows", "dtype", "width", "view"])
def test_code_tables_refuses_what_its_kernel_does_not_take(bad):
    counts = torch.ones((2, 256), dtype=torch.int64)
    arg = {"rows": (counts, 256),
           "dtype": (counts.float(), 2),
           "width": (counts[:, :255].contiguous(), 2),
           "view": (torch.ones((256, 2), dtype=torch.int64).t(), 2)}[bad]
    with pytest.raises(ValueError):
        huffman_cuda.code_tables(*arg)


def test_code_tables_of_no_rows():
    lengths, tables = huffman_cuda.code_tables(
        torch.zeros((0, 256), dtype=torch.int32), 0)
    assert lengths.shape == (0, 256)
    assert all(v.shape[0] == 0 for v in tables.values())
