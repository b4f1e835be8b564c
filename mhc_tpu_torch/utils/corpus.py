"""The 100 MB benchmark corpus, the port's own copy.

`make_corpus` gives byte for byte what the reference's `bench.make_corpus`
gives for the same size and seed; `tests/test_torch_corpus.py` holds the
two equal. The port keeps its own copy so that `chip_smoke.py`, whose
reference digests were computed on this corpus, depends on no file of the
reference.
"""

from __future__ import annotations

import numpy as np


def make_corpus(n_bytes: int, seed: int = 42) -> bytes:
    """Deterministic mixed corpus: structured binary + markov-ish text +
    incompressible noise (BASELINE.json:9 'mixed text+binary')."""
    rng = np.random.default_rng(seed)
    parts = []
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
             b"dog", b"compression", b"entropy", b"huffman", b"markov",
             b"context", b"canonical", b"of", b"and", b"a", b"in", b"to"]
    while sum(map(len, parts)) < n_bytes:
        kind = rng.integers(0, 4)
        if kind == 0:  # text run
            chunk = bytearray()
            while len(chunk) < 1 << 16:
                chunk += words[rng.integers(len(words))]
                chunk += b" " if rng.random() < 0.85 else b".\n"
            parts.append(bytes(chunk))
        elif kind == 1:  # structured binary (counters)
            base = int(rng.integers(0, 1 << 24))
            parts.append(np.arange(base, base + (1 << 14),
                                   dtype="<u4").tobytes())
        elif kind == 2:  # repetitive
            parts.append(bytes(rng.integers(0, 256, 64, dtype=np.uint8))
                         * 1024)
        else:  # noise
            parts.append(rng.integers(0, 256, 1 << 16,
                                      dtype=np.uint8).tobytes())
    return b"".join(parts)[:n_bytes]
