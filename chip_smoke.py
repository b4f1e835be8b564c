#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mhc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's Markov main path at its real size — the 100 MB mixed
corpus of `bench.make_corpus` (seed 42), 64 KB blocks, 8 KB decode units,
12,800 unit streams resident on the card — through the entry points a
user calls, after building and checking every kernel on that path:

  1. device: fail without CUDA; print `nvidia-smi` name and power limit
  2. build:  nvcc each csrc/*.cu for sm_90a (ptxas resources printed)
  3. kernels: each kernel vs its plain PyTorch version on the main
     path's own inputs — exact equality (integer codec, tolerance 0),
     CUDA-event times of both (minimum over repeated calls)
  4. main path: engine.stage -> encode -> decode -> fetch_bytes with the
     launch counters reset before and read after; bit-exact round trip;
     container size and sha256 equal to the JAX reference's; the
     container decodes through api.decompress; encode and decode GB/s
  5. oracle: when `make -C oracle` builds, the container is no larger
     than the single-core C++ oracle's
Every phase prints one JSON line; any failure raises (non-zero exit, no
final line). The last line is the device summary.

Imports nothing of JAX or mhc_tpu.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
CORPUS_BYTES = 100 << 20
# mhc_tpu.api.compress(bench.make_corpus(100 << 20), mode="markov"):
REF_100MB_LEN = 82_068_481
REF_100MB_SHA256 = ("28da84b513c9d2ba04aea6cd708d97b5"
                    "a0727961c15f9ba9034e14d34e7ecdba")
# the same for bench.make_corpus(4 << 20) (checked by the CPU tests)
REF_4MB_SHA256 = ("54f0867e82f83dd27606e1a1df827687"
                  "846701316e48a2dc56f0a09f274bcc86")
TIMED_REPS = 3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def min_ms(torch, fn, reps: int):
    """(last result, minimum ms of `reps` calls after one warm-up call),
    each call timed alone with CUDA events."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return out, best


def max_abs_err(a, b) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def phase_device(torch) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)


def phase_build(names) -> None:
    from mhc_tpu_torch.ops.kernels import _build
    for name in names:
        t0 = time.perf_counter()
        _build.build(name)
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            ptxas = [ln.strip() for ln in f
                     if "registers" in ln or "spill" in ln]
        emit("build", kernel=name, source=_build.source(name),
             seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)


def phase_kernels(torch, data: bytes, dev) -> list:
    """Each kernel against its plain version on the main path's inputs."""
    from mhc_tpu_torch import engine
    from mhc_tpu_torch.models.entropy import MARKOV
    from mhc_tpu_torch.ops.kernels import (decode_cuda, encode_cuda,
                                           histogram_cuda)
    st = engine.stage(data, device=dev)
    u, nv = st.units, st.n_valid
    rows = []

    def compare(name, src, replaces, kern, plain, reps, plain_reps):
        got, ms = min_ms(torch, kern, reps)
        ref, plain_ms = min_ms(torch, plain, plain_reps)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(max_abs_err(a, b) for a, b in zip(got, ref))
        emit("kernel", kernel=name, shapes=[list(t.shape) for t in got],
             max_abs_err=err, tolerance=0, ms=ms, plain_ms=plain_ms)
        if err != 0:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err}); tolerance is 0")
        rows.append({"name": name, "route": "cuda",
                     "source": f"mhc_tpu_torch/csrc/{src}",
                     "replaces": replaces, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms})
        return got

    (counts,) = compare(
        "markov_hist", "histogram.cu",
        "mhc_tpu/ops/kernels/histogram_pallas.py:98",
        lambda: histogram_cuda.markov_hist(u, nv),
        lambda: histogram_cuda.markov_hist_plain(u, nv), 10, 3)
    lengths = MARKOV.lengths_from_counts(counts.cpu().numpy())
    t = MARKOV.tables_from_lengths(lengths, dev)
    compare("pack_units", "encode.cu",
            "mhc_tpu/ops/kernels/encode_pallas.py:711",
            lambda: encode_cuda.pack_units(u, nv, t["codes"], t["lengths"]),
            lambda: encode_cuda.pack_units_plain(u, nv, t["codes"],
                                                 t["lengths"]), 5, 2)
    enc = engine.encode(st, lengths=lengths)
    words, n_dec, _, t = engine.decode_inputs(enc)
    du = enc.decode_unit
    dec_args = (words, n_dec, t["lim"], t["base"], t["first_code"],
                t["sorted_syms"])
    compare("decode_units", "decode.cu",
            "mhc_tpu/ops/kernels/decode_pallas.py:857",
            lambda: decode_cuda.decode_units(*dec_args, n_out=du),
            lambda: decode_cuda.decode_units_plain(*dec_args, n_out=du),
            5, 1)
    return rows


def phase_main_path(torch, data: bytes, dev) -> tuple[bytes, dict]:
    from mhc_tpu_torch import api, engine
    from mhc_tpu_torch.ops.kernels import (decode_cuda, encode_cuda,
                                           histogram_cuda)
    from mhc_tpu_torch.utils import native
    wrappers = {"markov_hist": histogram_cuda.markov_hist,
                "pack_units": encode_cuda.pack_units,
                "decode_units": decode_cuda.decode_units}
    torch.cuda.reset_peak_memory_stats()

    for w in wrappers.values():
        w.launches = 0
    st = engine.stage(data, device=dev)
    enc = engine.encode(st)
    out = engine.decode(enc)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    if engine.fetch_bytes(enc, out) != data:
        raise AssertionError("main path round trip is not bit-exact")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    _, enc_ms = min_ms(torch, lambda: engine.encode(st), TIMED_REPS)
    _, dec_ms = min_ms(torch, lambda: engine.decode(enc), TIMED_REPS)
    peak = torch.cuda.max_memory_allocated()

    crc = zlib.crc32(data) & 0xFFFFFFFF
    blob = engine.assemble_container(enc, crc)
    digest = hashlib.sha256(blob).hexdigest()
    emit("main_path", n_bytes=len(data), n_units=enc.n_units,
         launches=launches,
         table_builder="native C++" if native.available() else "numpy",
         encode_ms=enc_ms, decode_ms=dec_ms,
         encode_GBps=len(data) / enc_ms / 1e6,
         decode_GBps=len(data) / dec_ms / 1e6,
         container_bytes=len(blob), ratio=len(blob) / len(data),
         sha256=digest, peak_device_bytes=peak)
    if len(blob) != REF_100MB_LEN or digest != REF_100MB_SHA256:
        raise AssertionError(
            f"container ({len(blob)} B, {digest}) differs from the JAX "
            f"reference's ({REF_100MB_LEN} B, {REF_100MB_SHA256})")
    if api.decompress(blob, device=dev) != data:
        raise AssertionError("api.decompress did not return the input")
    emit("decompress", ok=True)
    return blob, launches


def phase_oracle(blob: bytes, corpus_path: str) -> None:
    r = subprocess.run(["make", "-C", os.path.join(REPO, "oracle")],
                       capture_output=True, text=True, timeout=300)
    exe = os.path.join(REPO, "oracle", "mh_oracle")
    if r.returncode != 0 or not os.path.exists(exe):
        emit("oracle", skipped="make -C oracle failed")
        return
    res = subprocess.run([exe, "bench", "em", corpus_path],
                         capture_output=True, text=True, timeout=600,
                         check=True)
    ref = json.loads(res.stdout.strip())
    emit("oracle", oracle=ref, container_bytes=len(blob),
         vs_oracle=len(blob) / ref["compressed_bytes"])
    if len(blob) > ref["compressed_bytes"]:
        raise AssertionError("container is larger than the oracle's")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs only on a CUDA GPU")
    sys.path.insert(0, REPO)
    from bench import make_corpus
    from mhc_tpu_torch.ops.kernels import _build
    phase_device(torch)
    phase_build(("histogram", "encode", "decode"))
    dev = torch.device("cuda:0")
    data = make_corpus(CORPUS_BYTES)
    rows = phase_kernels(torch, data, dev)
    blob, launches = phase_main_path(torch, data, dev)
    corpus_path = os.path.join(_build.BUILD_DIR, "corpus_100mb.bin")
    with open(corpus_path, "wb") as f:
        f.write(data)
    phase_oracle(blob, corpus_path)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
