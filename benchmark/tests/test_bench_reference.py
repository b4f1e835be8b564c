"""The plain reference (benchmark/reference/codec.py) writes the format's
exact bytes: the JAX package's digests of the parameter grid's 64 KB-block
cases (a data file, nothing of that package imported), and the port's
own CPU route at about 1 MB (compared here; the reference itself imports
nothing of the port). Its controls break what they say they break."""

import hashlib
import json
import os

import numpy as np
import pytest

from conftest import ROOT
from benchmark import harness, inputs
from benchmark.reference import codec

GRID = os.path.join(ROOT, "tests", "data", "param_grid_ref.json")


def _grid_cases():
    from mhc_tpu_torch.utils import corpus
    with open(GRID) as f:
        table = json.load(f)["containers"]
    cases = []
    for mode in ("markov", "order0"):
        for arg, du, crc in corpus.grid_cases(mode, 65536):
            for name in ("empty", "one", "three", "skew4", "noise",
                         "fibonacci", "corpus"):
                cases.append((name, mode, arg, du, crc,
                              table[corpus.grid_key(name, mode, 65536, du,
                                                    crc)]))
    return cases


def test_reference_matches_the_grid_digests_at_64k_blocks():
    from mhc_tpu_torch.utils import corpus
    data = corpus.grid_inputs()
    cases = _grid_cases()
    assert len(cases) == 77
    for name, mode, arg, du, crc, (length, digest) in cases:
        blob = codec.encode(data[name], mode, 65536, arg, crc)
        assert (len(blob), hashlib.sha256(blob).hexdigest()) == \
            (length, digest), (name, mode, du, crc)


@pytest.mark.parametrize("mode", ["markov", "order0"])
def test_reference_matches_the_port_on_the_cpu(mode):
    from mhc_tpu_torch import api
    data = inputs.corpus((1 << 20) + 4099, 2**31 + 99).tobytes()
    du = 8192 if mode == "markov" else 16384
    want = api.compress(data, mode=mode, block_size=65536, decode_unit=du,
                        device="cpu")
    assert codec.encode(data, mode, 65536, du, crc=True) == want


def test_the_controls_break_their_guarantee():
    cfg = {"mode": "markov", "block_size": 65536, "decode_unit": 8192,
           "crc": True}
    obj = inputs.corpus(1 << 20, 11)
    ref = codec.encode(obj, "markov", 65536, 8192)
    no_crc = codec.encode(obj, "markov", 65536, 8192, control="no_crc")
    assert len(no_crc) == len(ref) - 4 and no_crc[6] == ref[6] & ~1
    no_lit = codec.encode(obj, "markov", 65536, 8192,
                          control="no_literals")
    assert no_lit != ref
    for blob in (no_crc, no_lit):
        checks, _ = harness.judge([(0, blob, obj.tobytes())], [obj], cfg)
        assert checks["container_bytes_off"][0] > 0
        assert checks["decoded_bytes_off"][0] == 0
    with pytest.raises(ValueError):
        codec.encode(obj, "markov", 65536, 8192, control="bogus")


def test_bytes_off_counts_differences_and_length():
    assert harness.bytes_off(b"abc", b"abc") == 0
    assert harness.bytes_off(b"abd", b"abc") == 1
    assert harness.bytes_off(b"ab", b"abcd") == 2
    assert harness.bytes_off(np.zeros(3, np.uint8).tobytes(), b"") == 3
