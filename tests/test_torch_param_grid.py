"""The port against the reference over the container's parameter grid
(`mhc_tpu_torch.utils.corpus`: `grid_inputs`, `grid_cases`): both modes,
block sizes from 1 byte to 1 MiB, every decode unit the port accepts, crc
on (and off at one block size), every input. On the CPU:

- each case's reference container has the length and sha256 that the
  committed table (`corpus.GRID_TABLE`, also read by `chip_smoke.py`'s
  `param_grid` phase on the card) records, and `mhc_tpu_torch.api.compress`
  writes those bytes with each pack method (tolerance 0: an integer
  codec);
- on the route block sizes, `hybrid` (0.5), the sharded pipeline on a
  world of one and the file functions (chained segments) write them too;
- every container decodes to its input on each route;
- a decode unit of 1 or 2 bytes under a larger block is refused with
  ValueError by every entry point before any work.

The reference runs with its XLA scatter packer and its padded payload
fetch (`MHC_PACK_METHOD=scatter`, `MHC_ENC_FETCH=padded`), the cheapest of
its CPU routes to compile, as every case compiles anew; its routes all
write the same bytes, and the table was written with its defaults:

    JAX_PLATFORMS=cpu python tests/test_torch_param_grid.py --write

The port's plain decode (K7's plain version) walks a unit's symbols one
torch step at a time, so on the CPU a container whose units hold more than
PLAIN_DECODE_SYMBOLS symbols is decoded by the host codec
(`hybrid.decompress` at host_fraction 1.0) instead of the plain K7; the
card decodes every case through each route.
"""

import hashlib
import json
import os
import sys
import threading
import urllib.request

import pytest
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from mhc_tpu import api as jax_api
from mhc_tpu_torch import api, engine, hybrid, serve
from mhc_tpu_torch.cli import main as cli_main
from mhc_tpu_torch.ops import bitpack
from mhc_tpu_torch.ops.kernels import stages_cuda
from mhc_tpu_torch.parallel import pipeline
from mhc_tpu_torch.utils import corpus

INPUTS = corpus.grid_inputs()
PLAIN_DECODE_SYMBOLS = 1024


@pytest.fixture(scope="module")
def table():
    return corpus.load_grid_table()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The grid is thousands of small torch calls: a pool of threads per
    test worker spins against the other workers' pools (beside five busy
    processes on 8 cores a case took 8x as long), so the file runs on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def cheap_reference_route():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MHC_PACK_METHOD", "scatter")
        mp.setenv("MHC_ENC_FETCH", "padded")
        yield


def digest(blob: bytes) -> list:
    return [len(blob), hashlib.sha256(blob).hexdigest()]


def cases(mode: str, block_size: int):
    """(key, input, decode_unit argument, resolved unit, crc) of the
    grid at (mode, block_size)."""
    for name, x in INPUTS.items():
        for arg, du, crc in corpus.grid_cases(mode, block_size):
            yield (corpus.grid_key(name, mode, block_size, du, crc), x, arg,
                   du, crc)


def plain_decodes(x: bytes, du: int) -> bool:
    return min(du, len(x)) <= PLAIN_DECODE_SYMBOLS


@pytest.mark.parametrize("block_size", corpus.GRID_BLOCK_SIZES)
@pytest.mark.parametrize("mode", corpus.GRID_MODES)
def test_grid_containers_are_the_references(table, mode, block_size):
    for key, x, arg, du, crc in cases(mode, block_size):
        ref = jax_api.compress(x, mode=mode, block_size=block_size,
                               decode_unit=arg, crc=crc)
        assert digest(ref) == table["containers"][key], key
        for pm in engine.PACK_METHODS:
            assert api.compress(x, mode=mode, block_size=block_size,
                                decode_unit=arg, crc=crc, device="cpu",
                                pack_method=pm) == ref, (key, pm)
        out = (api.decompress(ref, device="cpu") if plain_decodes(x, du)
               else hybrid.decompress(ref, host_fraction=1.0,
                                      device="cpu"))
        assert out == x, key


@pytest.mark.parametrize("block_size", corpus.GRID_ROUTE_BLOCK_SIZES)
@pytest.mark.parametrize("mode", corpus.GRID_MODES)
def test_grid_routes_write_the_references(table, mode, block_size,
                                          tmp_path):
    """hybrid at 0.5, the sharded pipeline on a world of one and the file
    functions at `corpus.GRID_SEGMENT` (the corpus input chains four
    containers: its file digest is the reference's `compress_file`'s)."""
    src, dst, back = (str(tmp_path / n) for n in ("in", "out", "back"))
    for key, x, arg, du, crc in cases(mode, block_size):
        want = table["containers"][key]
        kw = dict(mode=mode, block_size=block_size, decode_unit=arg,
                  crc=crc)
        blob = hybrid.compress(x, host_fraction=0.5, device="cpu", **kw)
        assert digest(blob) == want, key
        assert digest(pipeline.compress_sharded(x, device="cpu",
                                                **kw)) == want, key
        with open(src, "wb") as f:
            f.write(x)
        api.compress_file(src, dst, segment_size=corpus.GRID_SEGMENT,
                          device="cpu", **kw)
        with open(dst, "rb") as f:
            chain = f.read()
        if len(x) > corpus.GRID_SEGMENT:
            jax_api.compress_file(src, back, segment_size=corpus.GRID_SEGMENT,
                                  **kw)
            with open(back, "rb") as f:
                assert digest(f.read()) == table["files"][key], key
            assert digest(chain) == table["files"][key], key
        else:
            assert digest(chain) == want, key
        if plain_decodes(x, du):
            assert hybrid.decompress(blob, host_fraction=0.5,
                                     device="cpu") == x, key
            assert pipeline.decompress_sharded(blob, device="cpu") == x, key
            api.decompress_file(dst, back, device="cpu")
        else:
            api.decompress_file(dst, back, host_fraction=1.0, device="cpu")
        with open(back, "rb") as f:
            assert f.read() == x, key


def test_grid_table_holds_the_grid_and_nothing_else(table):
    keys = {key for mode in corpus.GRID_MODES
            for bs in corpus.GRID_BLOCK_SIZES
            for key, *_ in cases(mode, bs)}
    files = {key for mode in corpus.GRID_MODES
             for bs in corpus.GRID_ROUTE_BLOCK_SIZES
             for key, x, *_ in cases(mode, bs)
             if len(x) > corpus.GRID_SEGMENT}
    assert set(table["containers"]) == keys
    assert set(table["files"]) == files
    # block sizes 1 and 2 and the literal-heavy noise are in the table
    assert table["containers"]["corpus markov bs=1 du=1 crc=1"][0] > 0
    assert table["containers"]["noise order0 bs=2 du=2 crc=1"][0] > 0


# --- F4: units of 1 or 2 bytes --------------------------------------------

NARROW = [(4096, 2), (4096, 1), (4, 2), (2, 1)]


@pytest.mark.parametrize("block_size,du", NARROW)
@pytest.mark.parametrize("entry", ["api", "hybrid", "sharded", "file",
                                   "stage", "cli"])
def test_narrow_substream_units_are_refused(entry, block_size, du, tmp_path,
                                            capsys):
    """A decode unit under 4 bytes below its block is refused with
    ValueError before any work (the reference raises TypeError there);
    the file functions open no file, the CLI exits 1 with the message."""
    x = INPUTS["skew4"]
    src, dst = str(tmp_path / "in"), str(tmp_path / "out")
    with open(src, "wb") as f:
        f.write(x)
    kw = dict(block_size=block_size, decode_unit=du)
    calls = {
        "api": lambda: api.compress(x, device="cpu", **kw),
        "hybrid": lambda: hybrid.compress(x, device="cpu", **kw),
        "sharded": lambda: pipeline.compress_sharded(x, device="cpu", **kw),
        "file": lambda: api.compress_file(src, dst, device="cpu", **kw),
        "stage": lambda: engine.stage(x, device="cpu", **kw),
    }
    if entry == "cli":
        assert cli_main(["encode", "--device", "cpu", "--block-size",
                         str(block_size), "--decode-unit", str(du), src,
                         dst]) == 1
        assert "fewer than 4 bytes" in capsys.readouterr().err
    else:
        with pytest.raises(ValueError, match="fewer than 4 bytes"):
            calls[entry]()
    assert not os.path.exists(dst)


@pytest.mark.parametrize("du", [1, 2, 3])
def test_compact_units_plain_builds_no_literal_rows_unflagged(du,
                                                              monkeypatch):
    """K10+K8's plain version builds literal rows for the flagged units
    alone: units of 1-3 bytes with no flag compact their coded rows, and
    `literal_words` is never called."""
    def no_literals(*a):
        raise AssertionError("literal rows built with no unit flagged")

    monkeypatch.setattr(bitpack, "literal_words", no_literals)
    R, W = 5, bitpack.words_for_block(du)
    words = torch.arange(R * W, dtype=torch.int32).reshape(R, W)
    units = torch.full((R, du), 7, dtype=torch.uint8)
    n_valid = torch.full((R,), du, dtype=torch.int32)
    offsets = torch.arange(R + 1, dtype=torch.int64)
    literal = torch.zeros(R, dtype=torch.bool)
    out = stages_cuda.compact_units(words, units, n_valid, offsets, literal,
                                    R)
    assert out.tolist() == words[:, 0].tolist()


@pytest.mark.parametrize("du", [1, 2, 3, 6])
def test_literal_words_of_a_unit_off_whole_words_raise(du):
    units = torch.zeros((2, du), dtype=torch.uint8)
    with pytest.raises(ValueError, match=f"rows of {du} bytes"):
        bitpack.literal_words(units, torch.full((2,), du, dtype=torch.int32),
                              8)


@pytest.mark.parametrize("mode", corpus.GRID_MODES)
def test_served_compress_at_block_size_1_is_the_reference(table, mode):
    """POST /compress?block_size=1 answers 200 with the reference's bytes
    (it dropped the connection before), and /decompress reads them."""
    x = INPUTS["skew4"]
    srv = serve.make_server("127.0.0.1", 0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}"
        req = urllib.request.Request(
            f"{url}/compress?mode={mode}&block_size=1", data=x,
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            blob = r.read()
        key = corpus.grid_key("skew4", mode, 1, 1, True)
        assert digest(blob) == table["containers"][key]
        req = urllib.request.Request(f"{url}/decompress", data=blob,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.read() == x
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)


def write_table() -> None:
    """The reference's digests of the grid, with its default packer, into
    `corpus.GRID_TABLE`."""
    import tempfile
    out = {"containers": {}, "files": {}}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        for mode in corpus.GRID_MODES:
            for bs in corpus.GRID_BLOCK_SIZES:
                for key, x, arg, du, crc in cases(mode, bs):
                    out["containers"][key] = digest(jax_api.compress(
                        x, mode=mode, block_size=bs, decode_unit=arg,
                        crc=crc))
                    if (bs in corpus.GRID_ROUTE_BLOCK_SIZES
                            and len(x) > corpus.GRID_SEGMENT):
                        with open(src, "wb") as f:
                            f.write(x)
                        jax_api.compress_file(
                            src, dst, mode=mode, block_size=bs,
                            decode_unit=arg, crc=crc,
                            segment_size=corpus.GRID_SEGMENT)
                        with open(dst, "rb") as f:
                            out["files"][key] = digest(f.read())
    os.makedirs(os.path.dirname(corpus.GRID_TABLE), exist_ok=True)
    with open(corpus.GRID_TABLE, "w") as f:
        f.write("{\n" + ",\n".join(
            f'"{part}": {{\n' + ",\n".join(
                f"{json.dumps(k)}: {json.dumps(v)}"
                for k, v in sorted(out[part].items())) + "\n}"
            for part in ("containers", "files")) + "\n}\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit(f"usage: {sys.argv[0]} --write")
    write_table()
