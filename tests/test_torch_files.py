"""The port's file API and CLI (tests/test_files.py against
mhc_tpu_torch, minus the sharded test): segment chaining, the streaming
segment reader, the CLI round trip and `stat`; a chained file equals the
one `mhc_tpu.api.compress_file` writes, and the CLI refuses what is not
ported and a missing card."""

import json
import os

import pytest
import torch

from mhc_tpu import api as jax_api
from mhc_tpu_torch import api
from mhc_tpu_torch.cli import main as cli_main
from tests.corpus import english_like, mixed_binary


@pytest.fixture
def tmpfiles(tmp_path):
    def mk(name, data):
        p = tmp_path / name
        p.write_bytes(data)
        return str(p)
    return mk, tmp_path


def test_segment_chaining_roundtrip(tmpfiles):
    mk, tmp = tmpfiles
    data = mixed_binary(200_000, seed=31)
    src = mk("in.bin", data)
    dst, ref, back = (str(tmp / n) for n in ("out.mhc", "ref.mhc", "back"))
    rep = api.compress_file(src, dst, segment_size=60_000, device="cpu")
    assert rep["n_segments"] == 4
    jax_api.compress_file(src, ref, segment_size=60_000)
    assert open(dst, "rb").read() == open(ref, "rb").read()
    rep2 = api.decompress_file(dst, back, device="cpu")
    assert rep2["n_segments"] == 4
    assert open(back, "rb").read() == data


def test_single_segment_file(tmpfiles):
    mk, tmp = tmpfiles
    data = english_like(100_000, seed=32)
    src = mk("in.bin", data)
    dst, back = str(tmp / "out.mhc"), str(tmp / "back.bin")
    rep = api.compress_file(src, dst, device="cpu")
    assert rep["n_segments"] == 1
    api.decompress_file(dst, back, device="cpu")
    assert open(back, "rb").read() == data


def test_empty_file(tmpfiles):
    mk, tmp = tmpfiles
    src = mk("in.bin", b"")
    dst, back = str(tmp / "out.mhc"), str(tmp / "back.bin")
    rep = api.compress_file(src, dst, device="cpu")
    assert rep["n_segments"] == 1
    api.decompress_file(dst, back, device="cpu")
    assert open(back, "rb").read() == b""


def test_sharded_raises_naming_the_roadmap_item(tmpfiles):
    mk, tmp = tmpfiles
    src = mk("in.bin", b"abc")
    with pytest.raises(NotImplementedError, match="item 11"):
        api.compress_file(src, str(tmp / "out.mhc"), sharded=True,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        api.decompress_file(src, str(tmp / "back"), sharded=True,
                            device="cpu")


def test_cli_segmented_roundtrip(tmpfiles, capsys):
    mk, tmp = tmpfiles
    data = english_like(250_000, seed=34)
    src = mk("in.bin", data)
    dst, back = str(tmp / "out.mhc"), str(tmp / "back.bin")
    rc = cli_main(["encode", "--segment-size", "100K", "--report",
                   "--device", "cpu", src, dst])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["n_segments"] == 3
    rc = cli_main(["decode", "--report", "--device", "cpu", dst, back])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip())["n_segments"] == 3
    assert open(back, "rb").read() == data


def test_cli_stat_default_container(tmpfiles, capsys):
    mk, tmp = tmpfiles
    data = english_like(120_000, seed=35)
    src = mk("in.bin", data)
    dst = str(tmp / "out.mhc")
    assert cli_main(["encode", "--device", "cpu", src, dst]) == 0
    capsys.readouterr()
    assert cli_main(["stat", dst]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["payload_bytes"] > 0
    assert rep["orig_len"] == len(data)
    assert rep["decode_unit"] > 0
    assert rep["n_units"] >= rep["n_blocks"]
    assert (rep["header_bytes"] + rep["index_bytes"] + rep["table_bytes"]
            + rep["payload_bytes"]) <= rep["container_bytes"] + 8


def test_streaming_segment_reader(tmpfiles):
    """decompress_file does not buffer the whole file: _next_segment reads
    incrementally and every read is bounded by one segment."""
    mk, tmp = tmpfiles
    data = mixed_binary(700_000, seed=36)
    src = mk("in.bin", data)
    dst = str(tmp / "out.mhc")
    rep = api.compress_file(src, dst, segment_size=240_000, device="cpu")
    assert rep["n_segments"] == 3
    file_size = os.path.getsize(dst)

    class RecordingFile:
        def __init__(self, f):
            self.f = f
            self.reads = []

        def read(self, n=-1):
            b = self.f.read(n)
            self.reads.append(len(b))
            return b

    segs = []
    with open(dst, "rb") as raw:
        f = RecordingFile(raw)
        carry = b""
        while True:
            seg, carry = api._next_segment(f, carry)
            if seg is None:
                break
            segs.append(seg)
    assert len(segs) == 3
    assert sum(len(s) for s in segs) == file_size
    assert max(f.reads) < file_size
    assert b"".join(api.decompress(s, device="cpu") for s in segs) == data


@pytest.mark.parametrize("flag", ["--sharded", "--distributed"])
def test_cli_multi_gpu_flags_exit_1(tmpfiles, capsys, flag):
    mk, tmp = tmpfiles
    src = mk("in.bin", b"abc")
    assert cli_main(["encode", flag, "--device", "cpu", src,
                     str(tmp / "out.mhc")]) == 1
    assert "item 11" in capsys.readouterr().err


def test_cli_without_a_card_exits_1(tmpfiles, capsys, monkeypatch):
    """No card and no --device cpu: one error line, no traceback, and
    nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mk, tmp = tmpfiles
    src = mk("in.bin", b"abc" * 100)
    dst = str(tmp / "out.mhc")
    assert cli_main(["encode", src, dst]) == 1
    err = capsys.readouterr().err
    assert err.startswith("mhc: error:") and "Traceback" not in err
    assert not os.path.exists(dst)
