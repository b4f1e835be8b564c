"""Corruption robustness of the port (tests/test_corrupt.py against
mhc_tpu_torch): a damaged container raises a clean ValueError or returns
the right bytes, never other bytes and never another exception. 1 KB
decode units keep the CPU's plain decode short."""

import struct

import numpy as np
import pytest

from mhc_tpu_torch import api
from tests.corpus import english_like

DATA = english_like(60_000, seed=77)


@pytest.fixture(scope="module")
def blob():
    return api.compress(DATA, mode="markov", block_size=1024, device="cpu")


def _try(blob_bytes):
    try:
        out = api.decompress(bytes(blob_bytes), device="cpu")
    except ValueError:
        return "error"
    except Exception as e:  # noqa: BLE001
        raise AssertionError(f"non-ValueError escaped: "
                             f"{type(e).__name__}: {e}")
    return "ok" if out == DATA else "WRONG"


def test_truncation_every_boundary(blob):
    for cut in [0, 1, 7, 8, 23, 24, 100, len(blob) // 2, len(blob) - 5,
                len(blob) - 1]:
        assert _try(blob[:cut]) == "error", cut


def test_random_truncations(blob):
    rng = np.random.default_rng(0)
    for _ in range(25):
        cut = int(rng.integers(0, len(blob)))
        assert _try(blob[:cut]) == "error", cut


def test_bit_flips_everywhere(blob):
    rng = np.random.default_rng(1)
    arr = np.frombuffer(blob, np.uint8).copy()
    for _ in range(40):
        pos = int(rng.integers(0, arr.size))
        mutated = arr.copy()
        mutated[pos] ^= 1 << int(rng.integers(0, 8))
        # "ok" only where the flip hit bits that decode ignores
        assert _try(mutated.tobytes()) in ("error", "ok"), pos


def test_appended_garbage_single_decompress(blob):
    assert api.decompress(blob + b"garbage-tail", device="cpu") == DATA


def test_extreme_header_values():
    head = struct.pack("<4sBBBBQII", b"MHTC", 1, 1, 0, 0,
                       1 << 62, 65536, 1 << 30)
    with pytest.raises(ValueError):
        api.decompress(head, device="cpu")
