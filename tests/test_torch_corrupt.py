"""Corruption robustness of the port (tests/test_corrupt.py against
mhc_tpu_torch): a damaged container raises a clean ValueError or returns
the right bytes, never other bytes and never another exception. 1 KB
decode units keep the CPU's plain decode short. A container whose length
index is rewritten so that one unit claims the whole payload still
parses; the decoders raise before they size a buffer by the claim."""

import struct

import numpy as np
import pytest
import torch

from mhc_tpu_torch import api, container, engine, hybrid
from mhc_tpu_torch.models.entropy import get_model
from mhc_tpu_torch.ops import bitpack
from mhc_tpu_torch.utils import native
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


# ---------------------------------------------------------------------------
# A length index that claims more than the encoder can write. The payload
# size, and so the parse, stay as they were; the decoders must raise before
# they size the expansion by the claim.
# ---------------------------------------------------------------------------

LAYOUTS = {
    # name: (mode, block_size, decode_unit)
    "legacy_u32_bits": ("markov", 1024, 1024),
    "substreams_aligned": ("markov", 4096, 1024),
    "order0_unaligned": ("huffman", 4096, 1024),
}


def _with_unit_lengths(blob_bytes: bytes, byte_lens: np.ndarray) -> bytes:
    """The container with its length index rewritten to `byte_lens`
    (layout bytes per unit, the same sum): the legacy index holds u32 bit
    lengths, the substream index is written in its plain bit-packed
    form (word counts in the aligned layout)."""
    meta = container.parse_container(blob_bytes)
    assert int(byte_lens.sum()) == int(meta.byte_lengths.sum())
    start = meta.payload_off - meta.index_bytes
    head = bytearray(blob_bytes[:start])
    if meta.decode_unit is None:
        index = (byte_lens * 8).astype("<u4").tobytes()
    else:
        aligned = bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD)
        index = container.pack_index(byte_lens // 4 if aligned else byte_lens)
        head[6] = ((meta.flags | container.FLAG_PACKED_INDEX)
                   & ~(container.FLAG_ENTROPY_INDEX
                       | container.FLAG_GROUPED_INDEX))
    bad = bytes(head) + index + blob_bytes[meta.payload_off:]
    assert np.array_equal(container.parse_container(bad).byte_lengths,
                          byte_lens)
    return bad


def _unit_zero_claims_payload(blob_bytes: bytes) -> bytes:
    meta = container.parse_container(blob_bytes)
    lens = np.zeros_like(meta.byte_lengths)
    lens[0] = meta.byte_lengths.sum()
    return _with_unit_lengths(blob_bytes, lens)


@pytest.fixture(scope="module", params=list(LAYOUTS))
def claimed(request):
    mode, block_size, du = LAYOUTS[request.param]
    good = api.compress(DATA, mode=mode, block_size=block_size,
                        decode_unit=du, device="cpu")
    assert api.decompress(good, device="cpu") == DATA
    return _unit_zero_claims_payload(good)


@pytest.fixture
def no_expansion(monkeypatch):
    """The error must come before the expansion buffer is sized."""
    def fail(*args, **kwargs):
        raise AssertionError("the expansion was called")
    monkeypatch.setattr(bitpack, "device_expand_words", fail)
    monkeypatch.setattr(bitpack, "device_expand_words_u32", fail)


def test_unit_claiming_the_payload_raises_in_decompress(claimed,
                                                        no_expansion):
    with pytest.raises(ValueError, match="unit length"):
        api.decompress(claimed, device="cpu")


def _parsed_result(blob_bytes: bytes) -> engine.EncodeResult:
    """The EncodeResult api.decompress hands engine.decode, all units in
    one chunk."""
    meta = container.parse_container(blob_bytes)
    aligned = bool(meta.flags & container.FLAG_ALIGNED_PAYLOAD)
    payload = torch.from_numpy(np.frombuffer(
        blob_bytes, np.uint8, count=int(meta.byte_lengths.sum()),
        offset=meta.payload_off).copy())
    return engine.EncodeResult(
        mode=get_model(meta.mode).name, block_size=meta.block_size,
        decode_unit=meta.decode_unit or meta.block_size,
        orig_len=meta.orig_len, n_units=len(meta.byte_lengths),
        lengths=meta.lengths, byte_lens=meta.byte_lengths, bit_lens=None,
        payload=bitpack.be_bytes_to_words(payload) if aligned else payload,
        raw_units=bool(meta.flags & container.FLAG_RAW_UNITS),
        aligned=aligned)


def test_unit_claiming_the_payload_raises_in_engine_decode(claimed,
                                                           no_expansion):
    with pytest.raises(ValueError, match="unit length"):
        engine.decode(_parsed_result(claimed))


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0],
                         ids=["device_half", "both", "host_half"])
def test_unit_claiming_the_payload_raises_in_hybrid(claimed, no_expansion,
                                                    monkeypatch, frac):
    def fail(*args, **kwargs):
        raise AssertionError("the host decode was called")
    monkeypatch.setattr(native, "decode_units", fail)
    with pytest.raises(ValueError, match="unit length"):
        hybrid.decompress(claimed, host_fraction=frac, device="cpu")


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_unit_at_the_encoders_longest_stream_still_decodes(mode):
    """All-15-bit codes and decode_unit == block_size (no literal units):
    every full unit's stream is the longest the encoder writes, du * 15
    bits — in the unaligned layout exactly the limit, ceil(du * 15 / 8)
    bytes — and the container decodes; one byte (one word) past the
    limit raises."""
    du = 512
    markov = mode == "markov"
    lengths = np.full((256, 256) if markov else (256,), 15, np.uint8)
    data = np.random.default_rng(5).integers(
        0, 256, 5 * du + 77, dtype=np.uint8).tobytes()
    st = engine.stage(data, mode=mode, block_size=du, decode_unit=du,
                      device="cpu")
    enc = engine.encode(st, lengths=lengths)
    assert int(enc.bit_lens.max()) == du * 15
    limit = (bitpack.words_for_block(du) * 4 if markov
             else -(-du * 15 // 8))
    assert int(enc.byte_lens.max()) == (limit - 4 if markov else limit)
    assert engine.fetch_bytes(enc, engine.decode(enc)) == data
    blob_bytes = engine.assemble_container(enc, None)
    assert api.decompress(blob_bytes, device="cpu") == data
    at_limit = np.array([limit, 0])
    engine.check_unit_lengths(at_limit, du, markov)
    with pytest.raises(ValueError, match="unit length"):
        engine.check_unit_lengths(at_limit + (4 if markov else 1), du,
                                  markov)
