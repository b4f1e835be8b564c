"""The benchmark's inputs: a mixed corpus of text and binary, from a seed.

The mix is BASELINE config 3's "mixed corpus (text+binary)" as the
program's `make_corpus` defines it, four kinds of 64 KB part:
  text      words of a 19-word vocabulary, each followed by a space at
            0.85 or else ".\n", until the part holds at least 65,536 bytes;
  counters  16,384 little-endian u32 counters from a random base below
            2**24;
  repeat    64 random bytes repeated 1,024 times;
  noise     65,536 uniformly random bytes.
Here the parts are drawn with vectorised numpy, not a Python loop a
word, so 100 MB takes about a second instead of half a minute. The bytes
differ from `make_corpus`'s.

The kinds' shares are fixed by the traffic mix (`kinds`, weights that
sum to 1): each kind gets its share of the parts, rounded, and the seed
orders them and fills them. So every seed does the same work in another
order, and the spread between seeds is not a change in the mix.
"""

from __future__ import annotations

import numpy as np

KINDS = ("text", "counters", "repeat", "noise")
PART_BYTES = 1 << 16
WORDS = (b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
         b"dog", b"compression", b"entropy", b"huffman", b"markov",
         b"context", b"canonical", b"of", b"and", b"a", b"in", b"to")
SPACE_P = 0.85


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for `seed` (any integer) and a stream of sub-keys."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def _text_tokens():
    """Token table: each word with " " (even rows) or ".\n" (odd rows),
    as (table (38, 13) uint8, lengths (38,))."""
    toks = [w + sep for w in WORDS for sep in (b" ", b".\n")]
    width = max(map(len, toks))
    table = np.zeros((len(toks), width), np.uint8)
    for i, t in enumerate(toks):
        table[i, :len(t)] = np.frombuffer(t, np.uint8)
    return table, np.array([len(t) for t in toks], np.int64)


def _text_parts(rng: np.random.Generator, n_parts: int,
                group: int = 64) -> list:
    """`n_parts` text parts, each its tokens up to the first that reaches
    PART_BYTES, drawn `group` parts at a time."""
    table, tok_len = _text_tokens()
    # the shortest token is 2 bytes: this many always reach PART_BYTES
    per = PART_BYTES // 2 + 1
    cols = np.arange(table.shape[1])[None, :]
    out = []
    for g in range(0, n_parts, group):
        m = min(group, n_parts - g)
        words = rng.integers(0, len(WORDS), (m, per))
        sep = rng.random((m, per)) >= SPACE_P
        ids = words * 2 + sep
        lens = tok_len[ids]
        count = (np.cumsum(lens, axis=1) < PART_BYTES).sum(axis=1) + 1
        for p in range(m):
            k = count[p]
            out.append(table[ids[p, :k]][cols < lens[p, :k, None]])
    return out


def kind_counts(n_parts: int, weights: dict) -> dict:
    """Parts of each kind: its weight's share of `n_parts`, rounded down,
    the parts left over given to the kinds of the largest remainders."""
    w = np.array([float(weights.get(k, 0.0)) for k in KINDS])
    if (w < 0).any() or not np.isclose(w.sum(), 1.0):
        raise ValueError(f"kind weights {weights} must be >= 0 and sum "
                         "to 1")
    exact = w * n_parts
    counts = np.floor(exact).astype(np.int64)
    rest = n_parts - int(counts.sum())
    for i in np.argsort(-(exact - counts), kind="stable")[:rest]:
        counts[i] += 1
    return dict(zip(KINDS, counts.tolist()))


def corpus(n_bytes: int, seed: int, weights: dict | None = None,
           stream: int = 0) -> np.ndarray:
    """`n_bytes` of the mixed corpus as a uint8 array, from `seed` and
    `stream` (distinct streams give distinct objects)."""
    weights = weights or {k: 0.25 for k in KINDS}
    n_parts = -(-n_bytes // PART_BYTES)
    counts = kind_counts(n_parts, weights)
    rng = rng_for(seed, stream)
    order = rng.permutation(np.repeat(np.arange(len(KINDS)),
                                      [counts[k] for k in KINDS]))
    parts: list = [None] * n_parts
    slots = {k: np.flatnonzero(order == i) for i, k in enumerate(KINDS)}
    for p, data in zip(slots["text"], _text_parts(rng, counts["text"])):
        parts[p] = data
    bases = rng.integers(0, 1 << 24, counts["counters"])
    step = np.arange(PART_BYTES // 4, dtype=np.uint32)
    for p, base in zip(slots["counters"], bases):
        parts[p] = (step + np.uint32(base)).astype("<u4").view(np.uint8)
    seeds = rng.integers(0, 256, (counts["repeat"], 64), dtype=np.uint8)
    for p, s in zip(slots["repeat"], seeds):
        parts[p] = np.tile(s, PART_BYTES // 64)
    noise = rng.integers(0, 256, (counts["noise"], PART_BYTES),
                         dtype=np.uint8)
    for p, row in zip(slots["noise"], noise):
        parts[p] = row
    out = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return out[:n_bytes]


def part_kinds(n_bytes: int, seed: int, weights: dict | None = None,
               stream: int = 0) -> list:
    """The kind of each part of `corpus(n_bytes, seed, weights, stream)`,
    in order (for tests)."""
    weights = weights or {k: 0.25 for k in KINDS}
    n_parts = -(-n_bytes // PART_BYTES)
    counts = kind_counts(n_parts, weights)
    rng = rng_for(seed, stream)
    order = rng.permutation(np.repeat(np.arange(len(KINDS)),
                                      [counts[k] for k in KINDS]))
    return [KINDS[i] for i in order]


def pool(n_objects: int, object_bytes: int, seed: int,
         weights: dict | None = None) -> list:
    """`n_objects` distinct objects of `object_bytes` each: object k is
    stream k of the seed."""
    return [corpus(object_bytes, seed, weights, stream=k)
            for k in range(n_objects)]
