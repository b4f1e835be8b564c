"""The writers' one parameter check, F6's default share and the decoded
rows' width.

- `api.resolve_decode_unit` is the one check of every writer: a block size
  that is not an int power of two in [1, 2**32) (the header's u32), or a
  decode unit that does not divide it, is refused with the same ValueError
  by `api.compress`, `hybrid.compress`, `compress_sharded` (a world of
  one), `compress_file`, the CLI's `encode` and `serve`'s /compress, before
  any byte is staged or encoded (F5: a block size of 0 raised
  ZeroDivisionError in three of them, and 2**32 `struct.error` after the
  whole encode).
- `hybrid`'s `host_fraction=None` reads MHC_HOST_FRACTION, else 0.5, as
  the reference's `_fraction` does (F6: it raised TypeError); a share
  outside [0, 1] raises ValueError naming where it came from.
- `engine.decode` sizes K7's rows by the bytes the result holds where its
  one unit is short (`engine.row_width`), also where that unit is literal
  and K14 writes its row.
"""

import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mhc_tpu_torch import api, container, engine, hybrid, serve
from mhc_tpu_torch.cli import main as cli_main
from mhc_tpu_torch.ops import bitpack
from mhc_tpu_torch.ops.kernels import decode_cuda, stages_cuda
from mhc_tpu_torch.parallel import pipeline
from mhc_tpu_torch.utils import native
from tests.corpus import english_like, mixed_binary

DATA = b"abcabc" * 10
BAD = {  # id: (block_size, decode_unit)
    "block_0": (0, None), "block_3": (3, None), "block_minus_4": (-4, None),
    "block_2_32": (1 << 32, None), "unit_3": (4096, 3),
    "block_float": (4096.0, None), "block_bool": (True, None)}


@pytest.fixture
def no_encode(monkeypatch):
    """Fails the test if anything is staged, histogrammed or encoded."""
    def fail(*args, **kwargs):
        raise AssertionError("the writer staged or encoded")
    for mod, fn in ((engine, "stage"), (engine, "encode"),
                    (api, "encode_range"), (native, "encode_units"),
                    (native, "hist_markov"), (native, "hist_order0")):
        monkeypatch.setattr(mod, fn, fail)


def _message(block_size, decode_unit) -> str:
    with pytest.raises(ValueError) as ei:
        api.resolve_decode_unit(block_size, decode_unit)
    return str(ei.value)


@pytest.mark.parametrize("case", list(BAD))
def test_every_writer_refuses_with_the_same_error(case, no_encode,
                                                  tmp_path):
    bs, du = BAD[case]
    want = _message(bs, du)
    src, dst = tmp_path / "in.bin", tmp_path / "out.mhc"
    src.write_bytes(DATA)
    kw = dict(block_size=bs, decode_unit=du)
    for writer in (
            lambda: api.compress(DATA, device="cpu", **kw),
            lambda: hybrid.compress(DATA, device="cpu", **kw),
            lambda: pipeline.compress_sharded(DATA, device="cpu", **kw),
            lambda: api.compress_file(str(src), str(dst), device="cpu",
                                      **kw),
            lambda: api.compress_file(str(src), str(dst), device="cpu",
                                      host_fraction=0.5, **kw),
            lambda: api.compress_file(str(src), str(dst), device="cpu",
                                      sharded=True, **kw)):
        with pytest.raises(ValueError) as ei:
            writer()
        assert str(ei.value) == want
    assert not dst.exists()


@pytest.mark.parametrize("block,unit", [("0", None), ("3", None),
                                        ("-4", None), ("4G", None),
                                        ("4K", "3")])
def test_cli_encode_refuses_with_the_same_error(block, unit, no_encode,
                                                tmp_path, capsys):
    src, dst = tmp_path / "in.bin", tmp_path / "out.mhc"
    src.write_bytes(DATA)
    argv = ["encode", "--device", "cpu", "--block-size", block]
    if unit:
        argv += ["--decode-unit", unit]
    assert cli_main(argv + [str(src), str(dst)]) == 1
    bs = {"0": 0, "3": 3, "-4": -4, "4G": 1 << 32, "4K": 4096}[block]
    want = _message(bs, int(unit) if unit else None)
    assert capsys.readouterr().err.strip() == f"mhc: error: {want}"
    assert not dst.exists()


def test_served_compress_refuses_with_the_same_error(no_encode):
    srv = serve.make_server("127.0.0.1", 0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        for bs in (0, 3, -4, 1 << 32):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_port}/compress?"
                f"block_size={bs}", data=DATA, method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=60)
            assert ei.value.code == 400
            assert ei.value.read().decode() == _message(bs, None)
        assert srv.stats.errors == 4
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)


@pytest.mark.parametrize("bs,du", [(1, None), (2, 2), (4, 4), (8, 4),
                                   (1 << 31, None), (1 << 31, 1 << 15),
                                   (np.int64(4096), np.int64(1024))])
def test_accepted_parameters_still_write(bs, du):
    """The bounds refuse nothing a writer wrote before: the smallest
    blocks, 2**31 (the largest power of two a u32 holds) and numpy
    ints."""
    blob = api.compress(DATA, block_size=bs, decode_unit=du, device="cpu")
    assert container.parse_container(blob).block_size == bs
    assert api.decompress(blob, device="cpu") == DATA


# ---------------------------------------------------------------------------
# F6: host_fraction=None.
# ---------------------------------------------------------------------------

HYBRID_DATA = mixed_binary(20_000, seed=166)


@pytest.fixture
def shares(monkeypatch):
    """The shares `hybrid` splits at, in call order."""
    seen = []
    real = hybrid._device_units

    def spy(R, host_fraction):
        seen.append(host_fraction)
        return real(R, host_fraction)
    monkeypatch.setattr(hybrid, "_device_units", spy)
    return seen


@pytest.mark.parametrize("env", [None, "0.25"], ids=["unset", "0.25"])
def test_host_fraction_none_is_the_default_share(env, shares, monkeypatch):
    """None with MHC_HOST_FRACTION unset splits at 0.5, and with it set to
    0.25 at 0.25: the bytes of the explicit share, both directions."""
    monkeypatch.delenv("MHC_HOST_FRACTION", raising=False)
    explicit = hybrid.compress(HYBRID_DATA, block_size=4096,
                               decode_unit=1024,
                               host_fraction=float(env or 0.5), device="cpu")
    if env is not None:
        monkeypatch.setenv("MHC_HOST_FRACTION", env)
    blob = hybrid.compress(HYBRID_DATA, block_size=4096, decode_unit=1024,
                           host_fraction=None, device="cpu")
    assert blob == explicit
    assert hybrid.decompress(blob, host_fraction=None,
                             device="cpu") == HYBRID_DATA
    assert shares == [float(env or 0.5)] * 3
    # the default argument is None
    assert hybrid.compress(HYBRID_DATA, block_size=4096, decode_unit=1024,
                           device="cpu") == explicit
    assert hybrid.decompress(blob, device="cpu") == HYBRID_DATA


@pytest.fixture(scope="module")
def small_blob():
    return api.compress(DATA, block_size=16, decode_unit=4, device="cpu")


@pytest.mark.parametrize("env,frac,name", [
    ("1.5", None, "MHC_HOST_FRACTION"), ("-0.1", None, "MHC_HOST_FRACTION"),
    ("half", None, "MHC_HOST_FRACTION"), ("0.5", 1.5, "host_fraction"),
    (None, -0.25, "host_fraction"), (None, float("nan"), "host_fraction")])
def test_host_fraction_out_of_range_names_its_source(env, frac, name,
                                                     small_blob,
                                                     monkeypatch, no_encode):
    monkeypatch.delenv("MHC_HOST_FRACTION", raising=False)
    if env is not None:
        monkeypatch.setenv("MHC_HOST_FRACTION", env)
    for fn in (lambda: hybrid.compress(DATA, host_fraction=frac,
                                       device="cpu"),
               lambda: hybrid.decompress(small_blob, host_fraction=frac,
                                         device="cpu")):
        with pytest.raises(ValueError, match=name):
            fn()


def test_file_functions_keep_none_as_no_hybrid(tmp_path, monkeypatch):
    """compress_file / decompress_file pass host_fraction through; their
    None still means no hybrid executor, whatever MHC_HOST_FRACTION says."""
    monkeypatch.setenv("MHC_HOST_FRACTION", "0.25")

    def fail(*args, **kwargs):
        raise AssertionError("the hybrid executor ran")
    src, dst, back = (tmp_path / n for n in ("in", "out.mhc", "back"))
    src.write_bytes(HYBRID_DATA)
    with monkeypatch.context() as m:
        m.setattr(hybrid, "compress", fail)
        m.setattr(hybrid, "decompress", fail)
        api.compress_file(str(src), str(dst), device="cpu")
        api.decompress_file(str(dst), str(back), device="cpu")
    assert back.read_bytes() == HYBRID_DATA
    ref = dst.read_bytes()
    api.compress_file(str(src), str(dst), host_fraction=0.25, device="cpu")
    assert dst.read_bytes() == ref
    api.decompress_file(str(dst), str(back), host_fraction=0.25,
                        device="cpu")
    assert back.read_bytes() == HYBRID_DATA


# ---------------------------------------------------------------------------
# The decoded rows' width.
# ---------------------------------------------------------------------------

def _short_literal_tail():
    """English text in 1 KB order-0 units, then a 21-byte unit of bytes
    the text never holds (128-255), which the encoder stores literally."""
    data = english_like(3 * 1024, seed=167) + bytes(
        np.random.default_rng(168).integers(128, 256, 21, dtype=np.uint8))
    blob = api.compress(data, mode="huffman", block_size=4096,
                        decode_unit=1024, device="cpu")
    meta = container.parse_container(blob)
    nv = engine.host_n_valid(meta.orig_len, 1024, len(meta.byte_lengths))
    raw = bitpack.raw_unit_mask(meta.byte_lengths, nv, False)
    assert raw.tolist() == [False] * 3 + [True] and nv[-1] == 21
    return data, blob


def test_short_literal_unit_decodes_in_a_row_of_whole_words(monkeypatch):
    """With a chunk of one unit, the last chunk is the 21-byte literal
    unit alone: K7 runs at n_out 32 (21 rounded up to 16 bytes, not the
    1 KB unit) and K14 writes the literal row in whole words."""
    data, blob = _short_literal_tail()
    monkeypatch.setattr(api, "CHUNK_BYTES", 1024)
    widths, literal = [], []
    real_decode, real_rows = decode_cuda.decode_units, \
        stages_cuda.literal_rows

    def decode_spy(*args, n_out, **kwargs):
        widths.append(n_out)
        return real_decode(*args, n_out=n_out, **kwargs)

    def rows_spy(out, words, rows):
        literal.append((out.shape[1], rows.tolist()))
        return real_rows(out, words, rows)
    monkeypatch.setattr(decode_cuda, "decode_units", decode_spy)
    monkeypatch.setattr(stages_cuda, "literal_rows", rows_spy)
    assert api.decompress(blob, device="cpu") == data
    assert widths == [1024, 1024, 1024, 32]
    assert literal[-1] == (32, [0])
    assert hybrid.decompress(blob, host_fraction=0.0,
                             device="cpu") == data


@pytest.mark.parametrize("orig,du,want", [(520, 4096, 528), (16, 16, 16),
                                          (1, 1, 1), (3, 2, 2),
                                          (5, 1024, 16), (3000, 1024, 1024)])
def test_row_width(orig, du, want):
    enc = engine.EncodeResult(
        mode="markov", block_size=du, decode_unit=du, orig_len=orig,
        n_units=-(-orig // du), lengths=None, byte_lens=None, bit_lens=None,
        payload=None)
    assert engine.row_width(enc) == want
