"""The chunked host-bytes compress / decompress of mhc_tpu_torch against
the JAX package: the container does not depend on the chunking (the
reference's tests/test_api.py::test_chunked_pipeline_container_identical),
for both modes. On the CPU the copies are plain; the chunk loop, the
summed histogram and the per-chunk payloads are what is held here."""

import pytest

from mhc_tpu import api as jax_api
from mhc_tpu_torch import api
from tests.corpus import mixed_binary

DATA = mixed_binary(60_001, seed=11)


@pytest.mark.parametrize("mode,du", [("markov", 8192), ("huffman", 16384)])
@pytest.mark.parametrize("units_per_chunk", [1, 3])
def test_chunked_container_identical(monkeypatch, mode, du,
                                     units_per_chunk):
    ref = jax_api.compress(DATA, mode=mode)
    assert api.compress(DATA, mode=mode, device="cpu") == ref
    monkeypatch.setattr(api, "CHUNK_BYTES", units_per_chunk * du)
    assert len(api._chunks(0, -(-len(DATA) // du), du)) > 1
    blob = api.compress(DATA, mode=mode, device="cpu")
    assert blob == ref
    assert api.decompress(blob, device="cpu") == DATA


def test_chunks_cover_every_unit_once(monkeypatch):
    monkeypatch.setattr(api, "CHUNK_BYTES", 3 * 8192 + 5)
    assert api._chunks(0, 7, 8192) == [(0, 3), (3, 6), (6, 7)]
    # a range from its own first unit, as a sharded rank's share
    assert api._chunks(5, 12, 8192) == [(5, 8), (8, 11), (11, 12)]
    monkeypatch.setattr(api, "CHUNK_BYTES", 100)
    assert api._chunks(0, 2, 8192) == [(0, 1), (1, 2)]
    assert api._chunks(0, 0, 8192) == []


def test_compression_report_adds_up():
    blob = api.compress(DATA, device="cpu")
    rep = api.compression_report(DATA, blob)
    assert rep == jax_api.compression_report(DATA, blob)
    assert (rep["header_bytes"] + rep["table_bytes"] + rep["index_bytes"]
            + rep["payload_bytes"] + 4 == rep["compressed_bytes"])
