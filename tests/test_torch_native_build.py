"""The port's host library builds into its own directory, atomically.

`mhc_tpu_torch.utils.native.build` compiles `native/*.cpp` into a build
directory by a per-process temporary file and `os.replace`: loaders that
start together on an empty directory all get a whole library, nothing
is written under `native/`, and a source newer than the library
triggers one rebuild.
"""

import json
import os
import subprocess
import sys

import pytest

from mhc_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")

_LOADER = r'''
import json, sys
from mhc_tpu_torch.utils import native
lib = native.load(sys.argv[1])
print(json.dumps(None if lib is None else
                 [lib.mhc_version(), lib.mhc_codec_version()]))
'''


def _listing(path: str) -> dict:
    return {f: os.stat(os.path.join(path, f)).st_mtime_ns
            for f in sorted(os.listdir(path))}


def test_concurrent_loaders_on_an_empty_build_dir(tmp_path):
    before = _listing(NATIVE)
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _LOADER, build_dir],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    want = [native._HOST_VERSION, native._CODEC_VERSION]
    assert results == [want] * 6
    assert os.listdir(build_dir) == [native.LIB_NAME]   # no temporaries
    assert _listing(NATIVE) == before


def test_a_newer_source_triggers_one_rebuild(tmp_path, monkeypatch):
    before = _listing(NATIVE)
    build_dir = str(tmp_path)
    so = native.build(build_dir)
    calls = []
    real_run = subprocess.run

    def counting_run(cmd, *a, **kw):
        calls.append(cmd[0])
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native.subprocess, "run", counting_run)
    assert native.build(build_dir) == so and calls == []    # fresh
    os.utime(so, (0, 0))          # both sources are now newer
    old_inode = os.stat(so).st_ino
    assert native.build(build_dir) == so
    assert calls == ["g++"]
    assert os.stat(so).st_mtime >= max(map(os.path.getmtime,
                                           native.SOURCES))
    assert os.stat(so).st_ino != old_inode                 # replaced whole
    assert native.build(build_dir) == so and calls == ["g++"]
    lib = native.load(build_dir)
    assert lib is not None and lib.mhc_version() == native._HOST_VERSION
    assert _listing(NATIVE) == before


def test_a_failed_build_leaves_nothing_and_loads_none(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(native, "CXXFLAGS", ["-DMHC_NO_SUCH_FLAG",
                                             "-no-such-gcc-option"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(str(tmp_path))
    assert os.listdir(tmp_path) == []
    assert native.load(str(tmp_path)) is None


def test_the_binding_runs_no_make_and_names_no_native_output():
    src = open(native.__file__).read()
    assert '"make"' not in src and "native/libmhc_host" not in src
    assert native.BUILD_DIR == os.path.join(REPO, "build", "mhc_tpu_torch")
