"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface, under `build/mhc_tpu_torch/`
at the repo root, and loaded with ctypes. A library is rebuilt when it
is missing or older than a source in `csrc/`. This happens at first use
on a CUDA tensor, never at import: the CPU tests import every module on
machines without nvcc.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()` as an int; `check` turns a non-zero code into an
exception with CUDA's own message, and `launched` counts the launch in
`LAUNCHES`, so a run can show which kernels its path went through. Each
wrapper call (its argument checks, output allocation, the C call and the
count; on the CPU its plain version) is one `utils.metrics.span`,
`mhc.launch.<kernel>` under the name `LAUNCHES` counts: the host's cost
to put that kernel on the card.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import glob
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mhc_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}

# Kernel launches by kernel name since the last `LAUNCHES.clear()`. Each
# wrapper counts here where it launches its kernel, and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source(name: str) -> str:
    """Repo-relative path of a kernel's source."""
    return os.path.relpath(os.path.join(_CSRC, f"{name}.cu"),
                           os.path.dirname(_PKG))


def build(name: str) -> str:
    """Compile csrc/<name>.cu if its library is stale; returns the .so
    path. Raises with nvcc's output when the build fails."""
    src = os.path.join(_CSRC, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    deps = [src] + glob.glob(os.path.join(_CSRC, "*.cuh"))
    if (os.path.exists(so)
            and os.path.getmtime(so) >= max(map(os.path.getmtime, deps))):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                       capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source(name)} "
                           f"(exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str, fn: str, argtypes: list):
    """The C function `fn` of kernel library `name`, typed, built on
    first use."""
    key = (name, fn)
    if key not in _libs:
        lib = ctypes.CDLL(build(name))
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        lib.mhc_error_string.argtypes = [ctypes.c_int]
        lib.mhc_error_string.restype = ctypes.c_char_p
        _libs[key] = (lib, f)
    return _libs[key]


def check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.mhc_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def launched(lib, rc: int, kernel: str) -> None:
    """`check` a launch's return code, then count the launch."""
    check(lib, rc, f"{kernel} launch")
    LAUNCHES[kernel] += 1


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (sizes the grids)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_or_cpu(*tensors) -> str:
    """The single device type all tensors share: 'cuda' or 'cpu'."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type
