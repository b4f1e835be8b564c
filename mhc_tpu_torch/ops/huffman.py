"""Huffman code-length assignment — deterministic, length-limited.

Counterpart of `mhc_tpu/ops/huffman.py`. The table build runs once per
encode on 256 contexts (Markov) or one row (order-0), on either side:
  host:   `rescale_counts` -> the native C++ builder in `utils/native.py`,
          or its numpy twin `code_lengths_np`;
  device: `code_lengths` on a counts tensor (K11, `ops/kernels/
          huffman_cuda.py`; the reference's `code_lengths` with
          `rescale_counts_jax`), the counts never leaving the device.
Ties are broken by (weight, then leaf-before-internal, then lower symbol)
and lengths are limited to MAX_CODE_LEN with the deflate-style overflow
repair. Both sides give the same bits for every input — containers are
a pure function of the input, and equal the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

# Maximum code length: the decoder peeks a fixed 15-bit window.
MAX_CODE_LEN = 15

# Weight ceiling: counts are rescaled so the total stays below this, which
# keeps every internal-merge sum exactly representable in int32.
_MAX_TOTAL = 1 << 28
_INF = np.int64(1) << 40


def rescale_counts(counts: np.ndarray) -> np.ndarray:
    """Scale down huge counts so totals fit int32; nonzero stays nonzero."""
    counts = np.asarray(counts, dtype=np.int64)
    total = counts.sum(axis=-1, keepdims=True)
    shift = np.zeros_like(total)
    while np.any(total >> shift >= _MAX_TOTAL):
        shift = np.where(total >> shift >= _MAX_TOTAL, shift + 1, shift)
    scaled = counts >> shift
    scaled = np.where(counts > 0, np.maximum(scaled, 1), 0)
    return scaled.astype(np.int32)


def code_lengths_np(counts: np.ndarray,
                    max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Length-limited Huffman code lengths for one 256-symbol context.

    Two-queue merge over symbols sorted by (count, symbol); ties prefer the
    leaf queue. Absent symbols (count 0) get length 0. Returns (256,) uint8.
    """
    counts = rescale_counts(np.asarray(counts)).astype(np.int64)
    n = counts.shape[0]
    present = counts > 0
    m = int(present.sum())
    lengths = np.zeros(n, dtype=np.uint8)
    if m == 0:
        return lengths
    if m == 1:
        lengths[np.argmax(present)] = 1
        return lengths

    order = np.lexsort((np.arange(n), counts + np.where(present, 0, _INF)))
    leaf_w = np.where(present[order], counts[order], _INF)

    int_w = np.full(n, _INF, dtype=np.int64)
    leaf_parent = np.full(n, -1, dtype=np.int32)
    int_parent = np.full(n, -1, dtype=np.int32)
    i = 0  # leaf read pointer
    j = 0  # internal read pointer
    for t in range(m - 1):
        for pick in range(2):
            lw = leaf_w[i] if i < n else _INF
            iw = int_w[j] if j < t else _INF
            if lw <= iw:
                leaf_parent[i] = t
                w = lw
                i += 1
            else:
                int_parent[j] = t
                w = iw
                j += 1
            int_w[t] = (int_w[t] if pick else 0) + w
    # depths: the root is internal node m-2, parents have higher indices
    depth = np.zeros(n, dtype=np.int32)
    for t in range(m - 3, -1, -1):
        depth[t] = depth[int_parent[t]] + 1
    sorted_lens = np.zeros(n, dtype=np.int32)
    for s in range(m):
        sorted_lens[s] = depth[leaf_parent[s]] + 1
    lengths_unsorted = np.zeros(n, dtype=np.int32)
    lengths_unsorted[order] = sorted_lens
    return limit_lengths_np(lengths_unsorted, max_len)


def limit_lengths_np(lengths: np.ndarray,
                     max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Kraft-budget overflow repair. Clamp lengths to max_len, then while the
    integer Kraft sum exceeds the 2**max_len budget, demote one leaf from
    the deepest non-max level; a closed-form promotion pass spends any
    leftover slack re-shortening the deepest codes. New lengths are handed
    out in (clamped length, symbol) order."""
    lengths = np.asarray(lengths, dtype=np.int64)
    n = lengths.shape[0]
    if int((lengths > max_len).sum()) == 0:
        return lengths.astype(np.uint8)
    clamped = np.minimum(lengths, max_len)
    bl = np.bincount(clamped, minlength=max_len + 2).astype(
        np.int64)[: max_len + 1]
    bl[0] = 0
    budget = 1 << max_len
    K = int(sum(bl[l] << (max_len - l) for l in range(1, max_len + 1)))
    while K > budget:
        bits = max(l for l in range(1, max_len) if bl[l] > 0)
        bl[bits] -= 1
        bl[bits + 1] += 1
        K -= 1 << (max_len - bits - 1)
    slack = budget - K
    for l in range(max_len, 1, -1):
        cost = 1 << (max_len - l)
        k = min(int(bl[l]), slack // cost)
        bl[l] -= k
        bl[l - 1] += k
        slack -= k * cost
    present_idx = np.nonzero(lengths > 0)[0]
    order = present_idx[np.lexsort((present_idx, clamped[present_idx]))]
    new_lens = np.zeros(n, dtype=np.uint8)
    new_lens[order] = np.repeat(np.arange(max_len + 1), bl)
    return new_lens


def code_lengths(counts: torch.Tensor) -> torch.Tensor:
    """(..., 256) int32 or int64 counts, on any device, unscaled -> uint8
    code lengths of the same shape on that device: `rescale_counts` then
    `code_lengths_np` for every row, computed where the counts are."""
    from .kernels import huffman_cuda
    flat = counts.reshape(-1, counts.shape[-1]).contiguous()
    return huffman_cuda.code_lengths(flat).reshape(counts.shape)
