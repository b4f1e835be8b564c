"""The calibration probes P1-P3: their inputs, the plain PyTorch version
of every body, and the dispatch to the kernels of csrc/probes.cu.

Counterparts of the reference's Pallas probes in `bench/`: P1
`loop_calib.py` (a loop over a (8, 128) u32 carry, four bodies at eight
configurations), P2 `mosaic_probe.py` (an int8 x int8 -> int32 product,
and the Markov histogram against a one-hot matmul histogram) and P3
`vpu_probe.py` (a loop over a (8, 128) i32 carry in [0, 256): a null
loop, one-hot builds and 256-deep picks on the CUDA cores, and the
one-hot fetch as a product on the tensor cores). Each body computes, bit
for bit, the array its reference computes for the same step count.

The plain versions repeat the reference's arithmetic as a step loop of
whole-tensor ops: P1 in int64 masked to 32 bits (the u32 wrap-around),
the result as int32 holding the u32 bits; P3 in the reference's types,
its products on 0/1 one-hots taken by float matmuls, exact for these
values. On a CUDA tensor each probe launches its kernel
(`ops/kernels/probes_cuda.py`); on the CPU, where the caller puts the
tensors only when it asks for the CPU, it runs its plain version.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from ..ops.kernels import _build, probes_cuda

LOOP_ITERS = 4096     # bench/loop_calib.py:31
VPU_ITERS = 1024      # bench/vpu_probe.py:36, its default
FETCH_DIV = 4         # the fetch cores run ITERS // 4 steps (:203, :225)

# P1: body -> (variant, ops a step), in the reference's order (:94-101)
LOOP_BODIES = {
    "chain_4": ("chain", 4), "chain_32": ("chain", 32),
    "chain_128": ("chain", 128), "chain_512": ("chain", 512),
    "scratch_8": ("scratch", 8), "store_32": ("store", 32),
    "wide_1": ("wide", 1), "wide_4": ("wide", 4),
}
# A one-op chain (c += c >> 1), the calibration of an integer op's
# dependent latency; the reference has none.
DEP_BODIES = {"dep1_32": ("dep", 32), "dep1_512": ("dep", 512)}
# P3: the bodies in the reference's order
VPU_BODIES = tuple(probes_cuda.VPU_VARIANTS)
FETCH_BODIES = ("fetch316_i8_matmul", "fetch316_bf16_matmul")

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Inputs, as the reference makes them
# ---------------------------------------------------------------------------

def loop_input(device) -> torch.Tensor:
    """P1's carry: arange(1024) as (8, 128) (u32 bits in int32)."""
    return torch.arange(1024, dtype=torch.int32,
                        device=device).reshape(8, 128)


def vpu_input(device) -> torch.Tensor:
    """P3's carry: arange(1024) & 255 as (8, 128) int32."""
    return loop_input(device) & 255


def _wrap_i8(v: torch.Tensor) -> torch.Tensor:
    """int values in [0, 256) as int8, 128..255 wrapped to negative (numpy's
    and JAX's astype(int8))."""
    return (((v + 128) & 255) - 128).to(torch.int8)


def vpu_operand(name: str, device) -> torch.Tensor | None:
    """The operand body `name` reads: the pick table (:145-147), before its
    broadcast over lanes, as (256, 8) in the body's type; or the fetch
    plane (:185-187, :221), (256, 316); None for the others."""
    if name.startswith("pick256_"):
        tab = torch.arange(256 * 8, dtype=torch.int32,
                           device=device).reshape(256, 8) & 255
        dtype = probes_cuda.VPU_OPERANDS[name][0]
        return (_wrap_i8(tab) if dtype == torch.int8 else tab.to(dtype))
    if name in FETCH_BODIES:
        rng = torch.arange(256 * 316, dtype=torch.int32,
                           device=device).reshape(256, 316) & 255
        return ((rng - 128).to(torch.int8) if name == "fetch316_i8_matmul"
                else rng.to(torch.bfloat16))
    return None


def i8_matmul_inputs(device):
    """P2's operands (:41-42): two (256, 256) int8 draws of
    default_rng(0).integers(-128, 127)."""
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 127, (256, 256), np.int8)
    b = rng.integers(-128, 127, (256, 256), np.int8)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def vpu_steps(name: str, iters: int) -> int:
    """The steps body `name` runs for the probe's ITERS."""
    return iters // FETCH_DIV if name in FETCH_BODIES else iters


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _as_i32(c: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> int32 with the same bits."""
    return torch.where(c > 0x7FFFFFFF, c - (1 << 32), c).to(torch.int32)


def loop_calib_plain(variant: str, n_ops: int, x: torch.Tensor,
                     iters: int) -> torch.Tensor:
    """bench/loop_calib.py:34-70, one step a loop turn."""
    x0 = x.to(torch.int64) & _M32
    c = x0
    iota = torch.arange(64, device=x.device)
    for _ in range(iters):
        # `store` is the chain; its pl.when writes on odd steps are
        # overwritten by the last one, of the final carry
        if variant in ("chain", "store"):
            for k in range(n_ops):
                c = ((c + (k + 1)) & _M32) ^ (c >> 1)
        elif variant == "scratch":
            for k in range(n_ops):
                scr = c.clone()
                c = (scr + (k + 1)) & _M32
        elif variant == "wide":
            for k in range(n_ops):
                sel = iota == (c & 63)[..., None]
                c = (c + torch.where(sel, x0[..., None], 0).sum(-1)) & _M32
        elif variant == "dep":
            for k in range(n_ops):
                c = (c + (c >> 1)) & _M32
        else:
            raise ValueError(f"unknown loop_calib variant {variant!r}")
    return _as_i32(c)


def vpu_probe_plain(name: str, x: torch.Tensor, steps: int,
                    operand: torch.Tensor | None = None) -> torch.Tensor:
    """bench/vpu_probe.py:71-220, body `name`, one step a loop turn."""
    dev = x.device
    iota = torch.arange(256, dtype=torch.int32, device=dev)[:, None, None]
    c = x
    if name.startswith("pick256_"):
        t = operand[:, :, None].expand(256, 8, 128)   # the lane broadcast
    if name in FETCH_BODIES:
        p = operand.to(torch.float32).T               # (316, 256), exact
    for _ in range(steps):
        if name == "null_loop":
            c = (c + 1) & 255
            continue
        sel = c[None] == iota                          # (256, 8, 128)
        if name == "onehot_i32cmp_i8cast_plus_pick":
            oh = sel.to(torch.int8)
            c = (oh.to(torch.int32) * iota).sum(0, dtype=torch.int32) & 255
        elif name == "onehot_bf16cmp_plus_pick_bf16":
            iota_bf = iota.to(torch.bfloat16)
            oh = (c.to(torch.bfloat16)[None] == iota_bf).to(torch.bfloat16)
            s = (oh * iota_bf).sum(0, dtype=torch.float32)
            c = s.to(torch.int32) & 255
        elif name == "onehot_16x16_i8mul_plus_pick":
            i16 = iota[:16]
            hi = ((c >> 4)[None] == i16).to(torch.int8)
            lo = ((c & 15)[None] == i16).to(torch.int8)
            oh = (hi[:, None] * lo[None]).reshape(256, 8, 128)
            c = (oh.to(torch.int32) * iota).sum(0, dtype=torch.int32) & 255
        elif name == "pick256_i32":
            c = torch.where(sel, t, 0).sum(0, dtype=torch.int32) & 255
        elif name == "pick256_i8mul_i32sum":
            prod = sel.to(torch.int8) * t
            c = prod.to(torch.int32).sum(0, dtype=torch.int32) & 255
        elif name == "pick256_i8mul_i8sum":
            prod = sel.to(torch.int8) * t
            c = prod.sum(0, dtype=torch.int8).to(torch.int32) & 255
        elif name == "pick256_f32":
            s = torch.where(sel, t, 0.0).sum(0)
            c = s.to(torch.int32) & 255
        elif name in FETCH_BODIES:
            # the (316, 256) . (256, 1024) one-hot product: at most one
            # nonzero term per sum, every value exact in float32
            oh = sel.reshape(256, 1024).to(torch.float32)
            xs = (p @ oh).reshape(316, 8, 128)
            if name == "fetch316_i8_matmul":
                s = xs[:16].to(torch.int32).sum(0, dtype=torch.int32) + 128 * 16
            else:
                s = xs[:16].sum(0).to(torch.int32)
            c = s & 255
        else:
            raise ValueError(f"unknown vpu_probe body {name!r}")
    return c


def i8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 by a float64 product: exact, as every partial
    sum is below 2^23 in magnitude."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def markov_hist_matmul(units: torch.Tensor,
                       n_valid: torch.Tensor) -> torch.Tensor:
    """The reference's one-hot matmul histogram (mhc_tpu/ops/histogram.py
    `_matmul_hist`, :63): (256, 256) int32 counts of (prev, cur) over the
    valid positions, the context 0 at each row's start, as A^T B of
    one-hots in float32, in chunks of 2^17 positions so that every partial
    count is an exact float."""
    u = units.long()
    prev = torch.nn.functional.pad(u[:, :-1], (1, 0)).reshape(-1)
    cur = u.reshape(-1)
    valid = (torch.arange(u.shape[1], device=u.device)[None, :]
             < n_valid.to(u.device).long()[:, None]).reshape(-1)
    acc = torch.zeros((256, 256), dtype=torch.int32, device=u.device)
    chunk = 1 << 17
    for i in range(0, cur.numel(), chunk):
        a = (torch.nn.functional.one_hot(prev[i:i + chunk], 256)
             * valid[i:i + chunk, None]).to(torch.float32)
        b = torch.nn.functional.one_hot(cur[i:i + chunk], 256).to(
            torch.float32)
        acc += (a.T @ b).to(torch.int32)
    return acc


# ---------------------------------------------------------------------------
# Dispatch: the kernel on a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    return _build.require_cuda_or_cpu(
        *(t for t in tensors if t is not None)) == "cpu"


def loop_calib(name: str, x: torch.Tensor, iters: int,
               cycles: torch.Tensor | None = None) -> torch.Tensor:
    """P1 body `name` (LOOP_BODIES or DEP_BODIES) for `iters` steps."""
    variant, n_ops = {**LOOP_BODIES, **DEP_BODIES}[name]
    if _on_cpu(x):
        return loop_calib_plain(variant, n_ops, x, iters)
    return probes_cuda.loop_calib(name, x, variant, n_ops, iters, cycles)


def vpu_probe(name: str, x: torch.Tensor, steps: int,
              operand: torch.Tensor | None = None,
              cycles: torch.Tensor | None = None) -> torch.Tensor:
    """P3 body `name` for `steps` steps (`vpu_steps` gives them for the
    probe's ITERS)."""
    if _on_cpu(x, operand):
        return vpu_probe_plain(name, x, steps, operand)
    return probes_cuda.vpu_probe(name, x, steps, operand, cycles)


def i8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P2: (M, K) int8 . (K, N) int8 -> (M, N) int32."""
    if _on_cpu(a, b):
        return i8_matmul_plain(a, b)
    return probes_cuda.i8_matmul(a, b)


# ---------------------------------------------------------------------------
# What the entry points share
# ---------------------------------------------------------------------------

def device_fields(device: torch.device) -> dict:
    """`platform` ("gpu" or "cpu"), and on a card its name and the
    `nvidia-smi` power limit."""
    if device.type != "cuda":
        return {"platform": "cpu"}
    idx = device.index if device.index is not None else 0
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={idx}"],
            capture_output=True, text=True, timeout=60)
        limit = smi.stdout.strip() if smi.returncode == 0 else "not read"
    except OSError:
        limit = "not read"
    return {"platform": "gpu", "device": torch.cuda.get_device_name(device),
            "power_limit": limit}


def best_seconds(fn, device: torch.device, reps: int = 3):
    """(last result, seconds): one warm-up call, then the minimum of
    `reps` calls, each between CUDA events on a card (on the CPU, the host
    clock)."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
    return out, best


def launches_since(before: dict, *prefixes: str) -> dict:
    """The launches of kernels whose names start with one of `prefixes`,
    counted since the snapshot `before` of `_build.LAUNCHES`."""
    return {k: v - before.get(k, 0) for k, v in sorted(_build.LAUNCHES.items())
            if k.startswith(prefixes) and v - before.get(k, 0)}


def resolve(prog: str, device: str | None) -> torch.device:
    """`config.resolve_device`, an entry point's exit 1 with its message
    where it raises (no card and no `--device cpu`)."""
    from ..config import resolve_device
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"{prog}: {e}") from None
