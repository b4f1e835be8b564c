"""K11 — the device table build: length-limited Huffman code lengths of
(rows, 256) counts, alone (`code_lengths`) or with the canonical tables
in the same launch (`code_tables`, the encode's build). CUDA kernel
wrappers + plain versions.

Kernel: csrc/huffman.cu (sm_90a), one 256-thread block per row. It
replaces mhc_tpu/ops/huffman.py::code_lengths with rescale_counts_jax (an
XLA stage on the TPU), and computes what the host builder does
(`ops/huffman.py`: rescale_counts -> code_lengths_np), with the rescale
taken on the int64 row total, so that device and host builds agree for
every input. Its time is the merge's serial chain of at most 255 steps
of two picks a row on one thread, both queue heads in registers, every
row in flight at once; the source note has the design. `code_tables`
runs K13's table body (csrc/canonical.cuh) in the same blocks on the
lengths they hold, so the encode's table build is one launch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import canonical
from . import _build, tables_cuda

MAX_CODE_LEN = 15
_MAX_TOTAL = 1 << 28
_INF = 1 << 30

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = [_P, ctypes.c_int, _I64, _P, _P]
_TABLES_ARGTYPES = [_P, ctypes.c_int, _I64, _I64, _P, _P, _P, _P, _P, _P,
                    _P, _P]


def _check(counts: torch.Tensor) -> str:
    dev = _build.require_cuda_or_cpu(counts)
    if (counts.dtype not in (torch.int32, torch.int64) or counts.dim() != 2
            or counts.shape[1] != 256):
        raise ValueError("counts must be a (rows, 256) int32 or int64 "
                         "tensor")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    return dev


def rescale_plain(counts: torch.Tensor) -> torch.Tensor:
    """rescale_counts on the int64 row totals: each row shifted right by
    the least s with total >> s < 2**28, nonzero counts kept at 1 or
    more. (rows, 256) int64."""
    c = counts.long()
    total = c.sum(dim=-1, keepdim=True)
    shift = torch.zeros_like(total)
    while True:
        over = (total >> shift) >= _MAX_TOTAL
        if not bool(over.any()):
            break
        shift += over.long()
    return torch.where(c > 0, (c >> shift).clamp(min=1), 0)


def _limit_plain(lengths: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """limit_lengths_np on the rows of (R, n) int64 `lengths` (m present
    symbols each): the Kraft demotion loop, the promotion pass, and the
    new lengths handed out in (clamped length, symbol) order."""
    R, n = lengths.shape
    dev = lengths.device
    present = lengths > 0
    clamped = lengths.clamp(max=MAX_CODE_LEN)
    ls = torch.arange(MAX_CODE_LEN + 1, device=dev)
    bl = ((clamped[..., None] == ls) & present[..., None]).sum(dim=-2)
    weight = torch.where(ls >= 1, 1 << (MAX_CODE_LEN - ls).clamp(min=0), 0)
    budget = 1 << MAX_CODE_LEN
    K = (bl * weight).sum(dim=-1)
    rows = torch.arange(R, device=dev)
    while True:
        dem = K > budget
        if not bool(dem.any()):
            break
        cand = torch.where((ls >= 1) & (ls < MAX_CODE_LEN) & (bl > 0), ls, -1)
        bits = cand.max(dim=-1).values
        r, b = rows[dem], bits[dem]
        bl[r, b] -= 1
        bl[r, b + 1] += 1
        K[r] -= torch.ones_like(b) << (MAX_CODE_LEN - 1 - b)
    slack = budget - K
    for l in range(MAX_CODE_LEN, 1, -1):
        cost = 1 << (MAX_CODE_LEN - l)
        k = torch.minimum(bl[:, l], slack // cost)
        bl[:, l] -= k
        bl[:, l - 1] += k
        slack -= k * cost
    sym = torch.arange(n, device=dev)
    order = torch.argsort(
        torch.where(present, clamped, MAX_CODE_LEN + 1) * n + sym, dim=-1)
    ranks = sym.expand(R, n).contiguous()
    new = torch.searchsorted(torch.cumsum(bl, dim=-1), ranks, right=True)
    new = torch.where(ranks < m[:, None], new, 0)
    return torch.zeros_like(lengths).scatter(1, order, new)


def code_lengths_plain(counts: torch.Tensor) -> torch.Tensor:
    """The host builder's lengths, vectorised over rows: (rows, 256)
    int32 or int64 counts -> (rows, 256) uint8. A stable sort on
    (weight, symbol), the two-queue merge as a loop over steps t of
    tensor ops across rows (ties to the leaf), the depths, and the
    length limit on the rows that need it."""
    w = rescale_plain(counts)
    R, n = w.shape
    dev = w.device
    present = w > 0
    m = present.sum(dim=-1)
    key, order = torch.sort(torch.where(present, w, _INF), dim=-1,
                            stable=True)
    # column n of each table takes the writes of rows whose step is done
    leaf_w = torch.cat([key, torch.full((R, 1), _INF, device=dev)], dim=1)
    int_w = torch.full((R, n + 1), _INF, dtype=torch.int64, device=dev)
    leaf_parent = torch.zeros((R, n + 1), dtype=torch.int64, device=dev)
    int_parent = torch.zeros((R, n + 1), dtype=torch.int64, device=dev)
    rows = torch.arange(R, device=dev)
    i = torch.zeros(R, dtype=torch.int64, device=dev)
    j = torch.zeros_like(i)
    steps = int(m.max()) - 1 if R else 0
    for t in range(steps):
        active = t < m - 1
        total = torch.zeros_like(i)
        for _ in range(2):
            lw = leaf_w[rows, i]
            iw = torch.where(j < t, int_w[rows, j], _INF)
            leaf = lw <= iw
            take_leaf, take_int = active & leaf, active & ~leaf
            leaf_parent[rows, torch.where(take_leaf, i, n)] = t
            int_parent[rows, torch.where(take_int, j, n)] = t
            total += torch.where(leaf, lw, iw)
            i += take_leaf
            j += take_int
        int_w[rows, torch.where(active, t, n)] = total
    # depths: the root is internal node m - 2, parents have higher indices
    depth = torch.zeros((R, n + 1), dtype=torch.int64, device=dev)
    for t in range(steps - 2, -1, -1):
        d = depth[rows, int_parent[:, t]] + 1
        depth[:, t] = torch.where(t <= m - 3, d, depth[:, t])
    sorted_lens = torch.where(torch.arange(n, device=dev) < m[:, None],
                              depth.gather(1, leaf_parent[:, :n]) + 1, 0)
    lengths = torch.zeros_like(w).scatter(1, order, sorted_lens)
    lengths = torch.where((m == 1)[:, None], present.long(), lengths)
    lengths = torch.where((m == 0)[:, None], 0, lengths)
    over = (lengths > MAX_CODE_LEN).any(dim=-1)
    if bool(over.any()):
        lengths[over] = _limit_plain(lengths[over], m[over])
    return lengths.to(torch.uint8)


def code_lengths(counts: torch.Tensor) -> torch.Tensor:
    """(rows, 256) int32 or int64 counts -> (rows, 256) uint8 code
    lengths on the counts' device. CPU tensors take the plain version;
    CUDA tensors launch K11."""
    if _check(counts) == "cpu":
        return code_lengths_plain(counts)
    lib, fn = _build.load("huffman", "mhc_code_lengths", _ARGTYPES)
    out = torch.empty(counts.shape, dtype=torch.uint8, device=counts.device)
    if counts.shape[0] == 0:
        return out
    rc = fn(counts.data_ptr(), int(counts.dtype == torch.int64),
            counts.shape[0], out.data_ptr(), _build.stream_ptr(counts.device))
    _build.launched(lib, rc, "code_lengths")
    return out


def code_tables_plain(counts: torch.Tensor, rows: int):
    """The fused table build's plain version: `code_lengths_plain`, then
    `canonical.canonical_tables_plain` of its lengths."""
    lengths = code_lengths_plain(counts)
    return lengths, canonical.canonical_tables_plain(lengths, rows)


def code_tables(counts: torch.Tensor, rows: int):
    """(L, 256) int32 or int64 counts, L == rows or 1 -> ((L, 256) uint8
    code lengths, the dict of `canonical.canonical_codes` as (rows, ...)
    int32 tables, each contiguous), on the counts' device; L == 1 repeats
    its tables over the rows (order-0). CPU tensors take the plain
    version; CUDA tensors launch the fused build, K11 and K13's bodies in
    one kernel."""
    dev = _check(counts)
    if counts.shape[0] not in (1, rows):
        raise ValueError(f"{counts.shape[0]} rows of counts for {rows} "
                         "rows of tables")
    if dev == "cpu":
        return code_tables_plain(counts, rows)
    lib, fn = _build.load("huffman", "mhc_code_tables", _TABLES_ARGTYPES)
    lengths = torch.empty(counts.shape, dtype=torch.uint8,
                          device=counts.device)
    tables = tables_cuda.empty_tables(rows, counts.device)
    if rows:
        rc = fn(counts.data_ptr(), int(counts.dtype == torch.int64),
                counts.shape[0], rows, lengths.data_ptr(),
                *(t.data_ptr() for t in tables.values()),
                _build.stream_ptr(counts.device))
        _build.launched(lib, rc, "code_tables")
    return lengths, tables
