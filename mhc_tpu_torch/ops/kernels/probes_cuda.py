"""P1-P3 — the calibration probes' kernels: ctypes wrappers of
csrc/probes.cu (sm_90a).

P1 `loop_calib` replaces bench/loop_calib.py:74, P2 `i8_matmul`
bench/mosaic_probe.py:44 and P3 `vpu_probe` bench/vpu_probe.py:41. Each
probe's loop runs inside one launch, its 1,024 independent carries
spread over the card's SMs (P1's `scratch` alone keeps one block), so
what it measures is its building block's latency or throughput on this
card (the source note says which). The plain versions and the dispatch
between them and these kernels are in `mhc_tpu_torch/bench/probes.py`;
these wrappers take CUDA tensors only. Each counts its launches in
`_build.LAUNCHES` under the body's name (`loop_calib/chain_4`,
`mosaic_probe/i8_matmul`, `vpu_probe/null_loop`, ...). `cycles`, a (1,)
int64 tensor on the same card, receives the loop's clock64() cycles
(thread 0 of block 0), the loop's time without the launch's.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess

import torch

from . import _build

LOOP_VARIANTS = {"chain": 0, "scratch": 1, "store": 2, "wide": 3, "dep": 4}
VPU_VARIANTS = {
    "null_loop": 0,
    "onehot_i32cmp_i8cast_plus_pick": 1,
    "onehot_bf16cmp_plus_pick_bf16": 2,
    "onehot_16x16_i8mul_plus_pick": 3,
    "pick256_i32": 4,
    "pick256_i8mul_i32sum": 5,
    "pick256_i8mul_i8sum": 6,
    "pick256_f32": 7,
    "fetch316_i8_matmul": 8,
    "fetch316_bf16_matmul": 9,
}
# the operand each P3 body reads: its dtype and shape
VPU_OPERANDS = {
    "pick256_i32": (torch.int32, (256, 8)),
    "pick256_i8mul_i32sum": (torch.int8, (256, 8)),
    "pick256_i8mul_i8sum": (torch.int8, (256, 8)),
    "pick256_f32": (torch.float32, (256, 8)),
    "fetch316_i8_matmul": (torch.int8, (256, 316)),
    "fetch316_bf16_matmul": (torch.bfloat16, (256, 316)),
}

_LOOP_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_MATMUL_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_VPU_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _require(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must lie on a CUDA device")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be a {tuple(shape)} {dtype} tensor")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _cycles_ptr(cycles, device) -> int | None:
    if cycles is None:
        return None
    _require(cycles, torch.int64, (1,), "cycles")
    if cycles.device != device:
        raise ValueError("cycles must lie on the carry's device")
    return cycles.data_ptr()


def _iters(iters: int) -> int:
    if not 0 <= iters < 1 << 31:
        raise ValueError(f"iters must be in [0, 2**31), got {iters}")
    return iters


def loop_calib(name: str, x: torch.Tensor, variant: str, n_ops: int,
               iters: int, cycles: torch.Tensor | None = None
               ) -> torch.Tensor:
    """P1 body `variant` with `n_ops` ops a step, `iters` steps, on the
    (8, 128) carry x (int32 holding the u32 bits); the (8, 128) int32
    result, the u32 bits. `name` is the launch counter's suffix."""
    _require(x, torch.int32, (8, 128), "x")
    lib, fn = _build.load("probes", "mhc_loop_calib", _LOOP_ARGS)
    out = torch.empty_like(x)
    rc = fn(x.data_ptr(), out.data_ptr(), LOOP_VARIANTS[variant], n_ops,
            _iters(iters), _cycles_ptr(cycles, x.device),
            _build.stream_ptr(x.device))
    _build.launched(lib, rc, f"loop_calib/{name}")
    return out


def i8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P2: (M, K) int8 . (K, N) int8 -> (M, N) int32 on wgmma;
    M % 16 == N % 8 == K % 32 == 0. A is read by TMA, which needs its
    base 16-byte aligned, and B by 8-byte loads: a view that is not
    aligned so is refused, not copied."""
    M, K = a.shape
    N = b.shape[1]
    _require(a, torch.int8, (M, K), "a")
    _require(b, torch.int8, (K, N), "b")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")
    if M % 16 or N % 8 or K % 32 or 0 in (M, N, K):
        raise ValueError("i8_matmul needs M % 16 == N % 8 == K % 32 == 0")
    if a.data_ptr() % 16 or b.data_ptr() % 8:
        raise ValueError("i8_matmul needs a 16-byte and b 8-byte aligned")
    lib, fn = _build.load("probes", "mhc_i8_matmul", _MATMUL_ARGS)
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
            _build.stream_ptr(a.device))
    _build.launched(lib, rc, "mosaic_probe/i8_matmul")
    return out


def vpu_probe(name: str, x: torch.Tensor, steps: int,
              operand: torch.Tensor | None = None,
              cycles: torch.Tensor | None = None) -> torch.Tensor:
    """P3 body `name` for `steps` steps on the (8, 128) int32 carry x in
    [0, 256), with its operand (VPU_OPERANDS: the (256, 8) pick table or
    the (256, 316) fetch plane) where it reads one; (8, 128) int32."""
    _require(x, torch.int32, (8, 128), "x")
    if name in VPU_OPERANDS:
        dtype, shape = VPU_OPERANDS[name]
        if operand is None:
            raise ValueError(f"{name} reads a {shape} {dtype} operand")
        _require(operand, dtype, shape, "operand")
        if operand.device != x.device:
            raise ValueError("the operand must lie on the carry's device")
        if operand.data_ptr() % 8:
            # the fetch cores read the plane by 4- and 8-byte words
            raise ValueError("the operand must be 8-byte aligned")
        ptr = operand.data_ptr()
    elif operand is not None:
        raise ValueError(f"{name} reads no operand")
    else:
        ptr = None
    lib, fn = _build.load("probes", "mhc_vpu_probe", _VPU_ARGS)
    out = torch.empty_like(x)
    rc = fn(x.data_ptr(), ptr, out.data_ptr(), VPU_VARIANTS[name],
            _iters(steps), _cycles_ptr(cycles, x.device),
            _build.stream_ptr(x.device))
    _build.launched(lib, rc, f"vpu_probe/{name}")
    return out


# SASS each checked kernel must hold, by (mangled) function name: the
# fetch cores and P2 their wgmma (IGMMA int8, HGMMA bf16), `scratch` its
# shared memory round trips. Template arguments: vpu_fetch_kernel<bf16 =
# 0 | 1>, loop_calib_kernel<1 (scratch), 8>; loop_calib_kernel<4 (dep),
# 512>, the one-op chain, is read for its instructions per op.
SASS_REQUIRED = {
    "vpu_fetch_kernelILb0E": ("IGMMA",),
    "vpu_fetch_kernelILb1E": ("HGMMA",),
    "i8_matmul_kernel": ("IGMMA",),
    "loop_calib_kernelILi1ELi8E": ("LDS", "STS"),
    "loop_calib_kernelILi4ELi512E": (),
}
# ... and what it must not: no mma.sync product is left
SASS_FORBIDDEN = {"i8_matmul_kernel": ("IMMA",),
                  "vpu_fetch_kernelILb0E": ("IMMA",),
                  "vpu_fetch_kernelILb1E": ("HMMA",)}


def sass_counts() -> dict:
    """{checked kernel: {opcode: count}}, read from `cuobjdump -sass` of
    the built libprobes.so; raises where a checked kernel is missing,
    lacks what SASS_REQUIRED asks of it or holds what SASS_FORBIDDEN
    does not allow."""
    so = _build.build("probes")
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts: dict = {}
    cur = None
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            key = next((k for k in SASS_REQUIRED if k in fn.group(1)), None)
            cur = counts.setdefault(key, collections.Counter()) if key else None
            continue
        op = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                       line)
        if cur is not None and op:
            cur[op.group(1)] += 1
    for key, ops in SASS_REQUIRED.items():
        missing = [o for o in ops if not counts.get(key, {}).get(o)]
        if key not in counts or missing:
            raise AssertionError(f"libprobes.so: {key} has no {missing} in "
                                 f"its SASS ({dict(counts.get(key, {}))})")
    for key, ops in SASS_FORBIDDEN.items():
        found = [o for o in ops if counts[key].get(o)]
        if found:
            raise AssertionError(f"libprobes.so: {key} holds {found} in its "
                                 f"SASS ({dict(counts[key])})")
    return {k: dict(v) for k, v in counts.items()}
