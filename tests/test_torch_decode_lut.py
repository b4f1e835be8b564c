"""K7's decode table (`decode_cuda.decode_lut_plain`) against the decode
contract, exhaustively, and the kernel's table-driven decode against
K7's plain version.

For every context and every 15-bit window w, the contract gives
len = 1 + #{l in 1..14 : w >= lim[l]} and sym = sorted_syms[clamp(bf[len]
+ (w >> (15 - len)), 0, 255)]. The table's entry for w's root window must
be exactly sym | len << 8, or the escape mark 0 iff len > the root's bits
(7 for Markov, 15 for order-0, which then never escapes). Length sets:
random valid ones, the all-15-bit worst case (every window escapes), and
the Markov and order-0 lengths of make_corpus(1 MB). `_lut_decode`
replays the decode kernel's loop (root entry, escape rows, sorted u8
symbols) in torch and must equal `decode_units_plain`.
"""

import numpy as np
import pytest
import torch

from mhc_tpu_torch.models.entropy import MARKOV, ORDER0
from mhc_tpu_torch.ops.huffman import MAX_CODE_LEN
from mhc_tpu_torch.ops.kernels import decode_cuda, encode_cuda
from mhc_tpu_torch.utils.corpus import make_corpus

_N_CORPUS = 1 << 20
_ESC = decode_cuda.ESC_FIRST     # the shortest code length that escapes


def _random_lengths(seed: int, markov: bool) -> np.ndarray:
    """Code lengths of random skewed counts, absent symbols included."""
    rng = np.random.default_rng(seed)
    shape = (256, 256) if markov else (256,)
    counts = rng.zipf(1.3 + rng.random(), shape).astype(np.int64)
    counts[rng.random(shape) < 0.3] = 0
    model = MARKOV if markov else ORDER0
    return model.lengths_from_counts(np.minimum(counts, 1 << 30))


def _corpus_lengths(markov: bool) -> np.ndarray:
    data = np.frombuffer(make_corpus(_N_CORPUS), np.uint8).astype(np.int64)
    if markov:
        prev = np.concatenate([[0], data[:-1]])
        counts = np.bincount(prev * 256 + data, minlength=65536)
        return MARKOV.lengths_from_counts(counts.reshape(256, 256))
    return ORDER0.lengths_from_counts(np.bincount(data, minlength=256))


def _lengths(case: str, markov: bool) -> np.ndarray:
    if case == "all15":
        shape = (256, 256) if markov else (256,)
        return np.full(shape, MAX_CODE_LEN, np.uint8)
    if case == "corpus":
        return _corpus_lengths(markov)
    return _random_lengths(int(case[len("random"):]), markov)


def _tables(case: str, markov: bool) -> dict:
    model = MARKOV if markov else ORDER0
    return model.tables_from_lengths(_lengths(case, markov), "cpu")


def _contract(t: dict, rows: slice):
    """(len, sym) of every 15-bit window for the contexts `rows`."""
    w = torch.arange(1 << MAX_CODE_LEN)
    lim = t["lim"][rows].long()
    bf = (t["base"] - t["first_code"])[rows].long()
    length = 1 + (w[None, :, None] >= lim[:, None, 1:MAX_CODE_LEN]).sum(-1)
    idx = (bf.gather(1, length) + (w[None, :] >> (MAX_CODE_LEN - length))
           ).clamp(0, 255)
    return length, t["sorted_syms"][rows].long().gather(1, idx)


_CASES = ["random1", "random2", "random3", "all15", "corpus"]


@pytest.mark.parametrize("markov", [True, False], ids=["markov", "order0"])
@pytest.mark.parametrize("case", _CASES)
def test_decode_lut_plain_follows_the_contract_for_every_window(case,
                                                                markov):
    t = _tables(case, markov)
    args = (t["lim"], t["base"], t["first_code"], t["sorted_syms"])
    lut = decode_cuda.decode_lut_plain(*args, markov=markov)
    assert lut.dtype == torch.uint8
    assert lut.numel() == decode_cuda.lut_bytes(markov)
    bits = decode_cuda.ROOT_BITS[markov]
    root, syms8, lims, bfs = decode_cuda.split_lut(lut, markov)
    root = root.long()
    rows = 256 if markov else 1
    assert root.shape == (rows, 1 << bits)
    escapes = 0
    for r0 in range(0, rows, 32):
        length, sym = _contract(t, slice(r0, min(r0 + 32, rows)))
        e = root[r0: r0 + 32].repeat_interleave(
            1 << (MAX_CODE_LEN - bits), dim=1)
        esc = e == 0
        assert torch.equal(esc, length > bits)
        assert torch.equal(e[~esc], (sym | length << 8)[~esc])
        escapes += int(esc.sum())
    if case == "all15":
        assert escapes == (rows << MAX_CODE_LEN if markov else 0)
    if markov:
        # the escape rows' 16-bit halves are exact for valid code lengths
        assert torch.equal(syms8.long(), t["sorted_syms"].long())
        bf = t["base"] - t["first_code"]
        assert torch.equal(lims, t["lim"][:, _ESC:MAX_CODE_LEN].long())
        assert torch.equal(bfs, bf[:, _ESC:].long())
    else:
        assert syms8 is lims is bfs is None


def _lut_decode(words, n_valid, lut, n_out: int, markov: bool):
    """The decode kernel's loop in torch, vectorised over units: the root
    entry of the context and window, else (escape) the escape row's
    compares over lengths 8..15 and the sorted u8 symbols."""
    R, W = words.shape
    bits = decode_cuda.ROOT_BITS[markov]
    root, syms8, lims, bfs = decode_cuda.split_lut(lut, markov)
    root = root.long()
    w64 = torch.zeros((R, W + 2), dtype=torch.long)
    w64[:, :W] = words.long() & 0xFFFFFFFF
    rows = torch.arange(R)
    pos = torch.zeros(R, dtype=torch.long)
    ctx = torch.zeros(R, dtype=torch.long)
    nv = n_valid.long().clamp(0, n_out)
    out = torch.zeros((R, n_out), dtype=torch.uint8)
    for t in range(int(nv.max()) if R else 0):
        wd, s = (pos >> 5).clamp(max=W), pos & 31
        top = ((((w64[rows, wd] << s) & 0xFFFFFFFF)
                | (w64[rows, wd + 1] >> (32 - s))) >> (32 - MAX_CODE_LEN))
        e = root[ctx, top >> (MAX_CODE_LEN - bits)]
        length, sym = e >> 8, e & 0xFF
        if markov:
            elen = _ESC + (top[:, None] >= lims[ctx]).sum(1)
            idx = (bfs[ctx].gather(1, (elen - _ESC)[:, None])[:, 0]
                   + (top >> (MAX_CODE_LEN - elen))).clamp(0, 255)
            escape = length == 0
            length = torch.where(escape, elen, length)
            sym = torch.where(escape, syms8.long()[ctx, idx], sym)
        valid = t < nv
        pos += torch.where(valid, length, 0)
        if markov:
            ctx = torch.where(valid, sym, ctx)
        out[:, t] = torch.where(valid, sym, 0).to(torch.uint8)
    return out


def _walk(lengths: np.ndarray, R: int, n: int, seed: int) -> np.ndarray:
    """(R, n) units whose every (prev, cur) pair has a code, drawn
    uniformly among the coded symbols (so long codes are in play), from
    context 0; a symbol whose own context codes nothing is never drawn."""
    rng = np.random.default_rng(seed)
    L = np.broadcast_to(lengths, (256, 256)) > 0
    L = L & L.any(1)[None, :]
    units = np.zeros((R, n), np.uint8)
    for r in range(R):
        prev = 0
        for j in range(n):
            prev = units[r, j] = rng.choice(np.nonzero(L[prev])[0])
    return units


@pytest.mark.parametrize("markov", [True, False], ids=["markov", "order0"])
@pytest.mark.parametrize("case", ["random4", "all15", "corpus"])
def test_table_driven_decode_equals_plain_decode(case, markov):
    """Units coded with the case's tables, ragged n_valid with a
    literal-style 0 and a 1, decode through the table as through the
    contract."""
    lengths = _lengths(case, markov)
    t = (MARKOV if markov else ORDER0).tables_from_lengths(lengths, "cpu")
    R, n = 12, 300
    units = torch.from_numpy(_walk(lengths, R, n, 7))
    nv = torch.full((R,), n, dtype=torch.int32)
    nv[torch.tensor([1, 4, 7])] = torch.tensor([0, 1, n // 2 + 3],
                                               dtype=torch.int32)
    words, _ = encode_cuda.pack_units_plain(units, nv, t["codes"],
                                            t["lengths"])
    args = (t["lim"], t["base"], t["first_code"], t["sorted_syms"])
    ref = decode_cuda.decode_units_plain(words, nv, *args, n_out=n,
                                         markov=markov)
    lut = decode_cuda.decode_lut_plain(*args, markov=markov)
    assert torch.equal(_lut_decode(words, nv, lut, n, markov), ref)
    valid = torch.arange(n)[None, :] < nv[:, None]
    assert torch.equal(ref[valid], units[valid])


def test_decode_lut_takes_cpu_tensors_to_its_plain_version():
    t = _tables("random5", True)
    args = (t["lim"], t["base"], t["first_code"], t["sorted_syms"])
    assert torch.equal(decode_cuda.decode_lut(*args),
                       decode_cuda.decode_lut_plain(*args))
    with pytest.raises(ValueError, match="lim"):
        decode_cuda.decode_lut(t["lim"][:, :8], *args[1:])


# The launch's layout (`decode_cuda.layout`), a pure function of the
# units R, the SM count and the mode.
_SMS = [132, 114, 1]


def _capped(R: int, sms: int, cap: int) -> tuple:
    """A block an SM at most, threads the units a block rounded up to a
    warp, at most `cap`."""
    blocks = min(sms, R)
    per = -(-R // blocks)
    return blocks, min(cap, -(-per // 32) * 32)


@pytest.mark.parametrize("sms", _SMS)
def test_layout_keeps_128_threads_a_block_up_to_128_units_an_sm(sms):
    for R in range(1, sms * 128 + 1):
        assert decode_cuda.layout(R, sms) == _capped(R, sms, 128)


def test_layout_runs_four_chains_a_scheduler_at_294914_units():
    blocks, threads = decode_cuda.layout(294_914, 132)
    assert (blocks, threads) == (132, 512)
    # 4.4 rounds: the last one partial, spread over every block
    assert -(-294_914 // (blocks * threads)) == 5
    assert decode_cuda.layout(16_897, 132) == (132, 160)


@pytest.mark.parametrize("markov", [True, False], ids=["markov", "order0"])
@pytest.mark.parametrize("sms", _SMS)
def test_layout_is_monotone_in_the_units(sms, markov):
    prev = (0, 0)
    for R in [*range(1, 70_000, 7), *range(70_000, 400_000, 997)]:
        blocks, threads = decode_cuda.layout(R, sms, markov)
        assert blocks >= prev[0] and threads >= prev[1]
        assert 1 <= blocks <= sms and threads % 32 == 0
        assert threads <= decode_cuda.MAX_THREADS[markov]
        prev = blocks, threads


@pytest.mark.parametrize("markov", [True, False], ids=["markov", "order0"])
def test_every_layout_fits_the_shared_memory_of_a_block(markov):
    threads = {decode_cuda.layout(R, 132, markov)[1]
               for R in range(1, 1_000_000, 101)}
    assert max(threads) == decode_cuda.MAX_THREADS[markov]
    for t in threads:
        smem = decode_cuda.lut_bytes(markov) + t * decode_cuda.RING_BYTES
        assert smem <= decode_cuda.SMEM_BYTES
    assert decode_cuda.lut_bytes(True) == 143_360


def test_order0_layout_keeps_1024_threads_a_block():
    for R in [*range(1, 20_000, 3), 135_168, 135_169, 1_000_000]:
        assert decode_cuda.layout(R, 132, False) == _capped(R, 132, 1024)


def test_layout_constants_match_the_kernel_source():
    """The wrapper's copy of the kernel's caps and table layout."""
    import pathlib
    import re
    src = (pathlib.Path(__file__).parents[1] / "mhc_tpu_torch" / "csrc"
           / "decode.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert re.search(r"kMaxThreads = kMarkov \? (\d+) : (\d+);", src
                     ).groups() == tuple(
        str(decode_cuda.MAX_THREADS[m]) for m in (True, False))
    assert (const("kRing") + 1) * 4 == decode_cuda.RING_BYTES
    assert const("kRootBits") == decode_cuda.ROOT_BITS[True]
    assert const("kEscStride") == decode_cuda.ESC_STRIDE
