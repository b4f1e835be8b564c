"""Fixtures shared by the port's test files; a file imports the ones it
uses into its namespace, where pytest finds them.

`one_torch_thread` (module-scoped, autouse where imported): the file's
tests run torch at one intra-op thread, the previous count restored
after the file. The suite runs one file a worker in several worker
processes at once; torch's default of a thread a core in each of them
oversubscribes the cores, and a file of many small torch ops then runs
hundreds of times slower than alone.

`no_host_library`: a function that leaves the port's host library
(`utils/native.py`) as it is where it cannot be built: an empty build
directory, compiler flags g++ refuses, and nothing loaded yet.
"""

import pytest
import torch

from mhc_tpu_torch.utils import native


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def no_host_library(tmp_path, monkeypatch):
    """A function that leaves the port's host library, until the test
    ends, as it is where it cannot be built."""
    def unbuildable():
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(native, "CXXFLAGS", ["-no-such-gcc-option"])
        monkeypatch.setattr(native, "_lib", None)
    return unbuildable
