"""The 100 MB benchmark corpus, the port's own copy, its tiling to
multi-GB inputs, and the parameter grid's inputs and cases.

`make_corpus` gives byte for byte what the reference's `bench.make_corpus`
gives for the same size and seed; `tests/test_torch_corpus.py` holds the
two equal. The port keeps its own copy so that `chip_smoke.py`, whose
reference digests were computed on this corpus, depends on no file of the
reference.

The parameter grid (`grid_inputs`, `grid_cases`) holds every route to the
reference's container bytes over the container's parameters: modes, block
sizes from 1 byte to 1 MiB, decode units and crc. Its digests, written by
the reference, are `GRID_TABLE`; `tests/test_torch_param_grid.py` checks
them on the CPU and `chip_smoke.py`'s `param_grid` phase on the card.
"""

from __future__ import annotations

import json
import os

import numpy as np

GRID_MODES = ("markov", "order0")
GRID_BLOCK_SIZES = (1, 2, 4, 16, 512, 4096, 65536, 1 << 20)
# decode_unit arguments; "block" stands for the case's block size
GRID_DECODE_UNITS = (None, 4, 16, 1024, 8192, "block")
GRID_CRC_OFF_BLOCK_SIZE = 512         # the one block size also run crc off
# the hybrid, sharded and file routes run these block sizes
GRID_ROUTE_BLOCK_SIZES = (1, 16, 65536)
GRID_SEGMENT = 100_000                # the file route's segment size
GRID_SEED = 15
GRID_TABLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "data", "param_grid_ref.json")


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


def tiled_corpus(n: int, tile_bytes: int = 100 << 20,
                 tile: bytes | None = None) -> bytes:
    """The first `n` bytes of `make_corpus(tile_bytes)` repeated: equal to
    `(make_corpus(tile_bytes) * k)[:n]` for any k covering n, built with
    one copy. `tile` is that corpus where the caller holds it already.
    The multi-GB inputs (BASELINE config 5) are tiled because a fresh
    `make_corpus` of gigabytes costs minutes on one CPU core; a segment
    whose size is no multiple of the tile starts at another offset in
    it."""
    if tile is None:
        tile = make_corpus(tile_bytes)
    elif len(tile) != tile_bytes:
        raise ValueError(f"tile of {len(tile)} bytes, not {tile_bytes}")
    full, rest = divmod(n, tile_bytes)
    return b"".join([tile] * full + [tile[:rest]])


def grid_inputs(seed: int = GRID_SEED) -> dict:
    """The grid's inputs by name, from `seed`: empty, 1 and 3 bytes; 5,000
    bytes over 4 skewed symbols; 70,001 bytes of uniform noise (literal
    units); 50,000 bytes whose 22 symbols have Fibonacci counts (code
    lengths past 15 bits, so the length limit acts); the first 300,001
    bytes of `make_corpus` (seed 42)."""
    rng = np.random.default_rng(seed)
    fib = [1, 1]
    while len(fib) < 22:
        fib.append(fib[-1] + fib[-2])
    fib[-1] += 50_000 - sum(fib)
    syms = rng.choice(256, 22, replace=False).astype(np.uint8)
    return {
        "empty": b"",
        "one": rng.integers(0, 256, 1, dtype=np.uint8).tobytes(),
        "three": rng.integers(0, 256, 3, dtype=np.uint8).tobytes(),
        "skew4": rng.choice(rng.choice(256, 4, replace=False).astype(
            np.uint8), 5_000, p=[0.7, 0.2, 0.07, 0.03]).tobytes(),
        "noise": rng.integers(0, 256, 70_001, dtype=np.uint8).tobytes(),
        "fibonacci": rng.permutation(np.repeat(syms, fib)).tobytes(),
        "corpus": make_corpus(300_001),
    }


def grid_cases(mode: str, block_size: int) -> list:
    """(decode_unit argument, resolved unit, crc) of the grid at (mode,
    block_size): each unit `resolve_decode_unit` accepts once, under the
    first argument of GRID_DECODE_UNITS that gives it (a refused one, or
    a unit of 1 or 2 bytes under a larger block, is no case), crc on; at
    GRID_CRC_OFF_BLOCK_SIZE each again with crc off."""
    from ..api import resolve_decode_unit
    cases, seen = [], set()
    for arg in GRID_DECODE_UNITS:
        arg = block_size if arg == "block" else arg
        try:
            du = resolve_decode_unit(block_size, arg, mode == "markov")
        except ValueError:
            continue
        if du not in seen:
            seen.add(du)
            cases.append((arg, du, True))
    if block_size == GRID_CRC_OFF_BLOCK_SIZE:
        cases += [(arg, du, False) for arg, du, _ in cases]
    return cases


def grid_key(name: str, mode: str, block_size: int, du: int,
             crc: bool) -> str:
    """The case's key in GRID_TABLE."""
    return f"{name} {mode} bs={block_size} du={du} crc={int(crc)}"


def load_grid_table() -> dict:
    """GRID_TABLE: {"containers": {key: [length, sha256]}, "files":
    {key: [length, sha256]}}, the reference's `compress` and, on the
    route block sizes, its `compress_file` at GRID_SEGMENT."""
    with open(GRID_TABLE) as f:
        return json.load(f)
