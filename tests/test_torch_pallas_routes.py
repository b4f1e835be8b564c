"""The "pallas" pack method end to end against the JAX package: K5, K6 and
K15's compactions (their plain versions on the CPU) write the container
`mhc_tpu.api.compress` writes, through `engine.encode` and through
`api.compress`, in both modes, with substream units (literal units in
play) and with decode_unit == block_size, where Markov takes the payload
route (the bubble stream straight to the payload, no rows)."""

import functools
import zlib

import numpy as np
import pytest

import mhc_tpu_torch
from mhc_tpu import api as jax_api
from mhc_tpu_torch import api, engine
from mhc_tpu_torch.ops.kernels import stages_cuda
from tests.corpus import english_like

BLOCK = 32768


@functools.lru_cache(maxsize=None)
def _case(mode: str, du: int | None):
    rng = np.random.default_rng(17)
    data = (english_like(70_000, seed=17)
            + rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()
            + english_like(23_457, seed=18))
    return data, jax_api.compress(data, mode=mode, block_size=BLOCK,
                                  decode_unit=du)


@pytest.mark.parametrize("entry", ["engine", "api"])
@pytest.mark.parametrize("du", [None, BLOCK], ids=["substreams", "du_block"])
@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_pallas_routes_write_the_reference(monkeypatch, mode, du, entry):
    data, ref = _case(mode, du)
    calls = []
    for name in ("compact_bubbles", "bubbles_to_payload"):
        real = getattr(stages_cuda, name)
        monkeypatch.setattr(stages_cuda, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    if entry == "engine":
        st = engine.stage(data, mode=mode, block_size=BLOCK, decode_unit=du,
                          device="cpu")
        blob = engine.assemble_container(
            engine.encode(st, pack_method="pallas"),
            zlib.crc32(data) & 0xFFFFFFFF)
    else:
        blob = api.compress(data, mode=mode, block_size=BLOCK,
                            decode_unit=du, device="cpu",
                            pack_method="pallas")
    assert blob == ref
    payload_route = mode == "markov" and du == BLOCK
    assert set(calls) == {"bubbles_to_payload" if payload_route
                          else "compact_bubbles"}
    assert mhc_tpu_torch.decompress(blob, device="cpu") == data
