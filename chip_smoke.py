#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mhc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at their real size on the 100 MB mixed corpus of
`mhc_tpu_torch.utils.corpus.make_corpus` (seed 42; the port's copy of
the reference's `bench.make_corpus`, the same bytes), 64 KB blocks, all
unit streams resident on the card, through the entry points a user
calls, after building and checking every kernel those paths run:

  1. device: fail without CUDA; print `nvidia-smi` name and power limit
  2. build:  nvcc each csrc/*.cu for sm_90a, all at once (ptxas
     resources printed)
  3. kernels: each kernel vs its plain PyTorch version on its path's own
     inputs — exact equality (integer codec, tolerance 0), CUDA-event
     times (the kernel and the library call: per call over runs of 10
     back to back; the plain version: single calls; minimum over the
     runs), the bound (bytes the function must move over 3.35 TB/s,
     coded words counted as this run's bits give them) and the library
     call over a prepared index
     (K1 and K2: a bare `torch.bincount`; K5: one `torch.take`, checked
     equal to K5): K1, K3, K5, K4, K6, K7's table build and K7m
     on the Markov inputs (12,800 units of 8 KB), with K4(K5(x)) and the
     compacted K6(K5(x)) == K3(x); K4 and K6 again on the payload route's
     inputs (1,600 units of 64 KB), with the same two checks; K2, K3 and
     K6 (again, in the same rows), K7's order-0 table build and K7o on
     the order-0 inputs (6,400 units of 16 KB)
  4. main path (Markov): engine.stage -> encode -> decode -> fetch_bytes
     with the launch counters reset before and read after (K1, K3, K7's
     table build and K7m once each); bit-exact
     round trip; container size and sha256 equal to the JAX reference's;
     the container decodes through api.decompress; encode and decode GB/s
  5. dense and pallas paths: the same Markov input through engine.encode
     with pack_method="dense" (K5 then K4) and "pallas" (K5 then K6, the
     bubble stream compacted), K3 never launched; the same container;
     encode GB/s, each timed in turns with the fused encode
  6. payload route: Markov with 64 KB decode units (== blocks, no
     literal units) through pack_method="pallas", whose bubble stream
     goes straight to the payload; the JAX reference's container for
     that unit size; bit-exact round trip through engine.decode
  7. order-0 path: engine.stage(mode="huffman") -> encode -> decode ->
     fetch_bytes, counters as in 4 (K2, K3, the order-0 table build and
     K7o launched, K1 not);
     bit-exact; the JAX reference's container; api.compress writes it and
     api.decompress reads it; encode and decode GB/s; then api.compress
     with pack_method="pallas" (K5, K6) writes it too
  8. host bytes: the chunked api.compress / api.decompress (at least two
     chunks), host bytes in and out, the reference container, timed in
     turns at 16 MB chunks and at the default `api.CHUNK_BYTES`
  9. CLI: `python -m mhc_tpu_torch.cli` encode (32 MB segments: a chain
     of 4 containers equal to mhc_tpu.api.compress_file's), decode (equal
     to the input), stat; wall seconds of each
  10. hybrid: hybrid.compress / decompress at host_fraction 0.5, the
     reference container, bit-exact, wall seconds
  11. corrupt containers on the card: a payload bit flip, a truncation
     and a bad magic each raise ValueError, and so does the payload
     route's container with its length index rewritten so that unit 0
     claims the whole payload, before anything is allocated for it
     (`torch.cuda.max_memory_allocated()` printed before and after);
     then a clean decode works
  12. oracle: `make -C oracle` builds the single-core C++ oracle (a
     failed build fails the run), and each container is no larger than
     the oracle's (em for Markov, e0 for order-0)
Every phase prints one JSON line; any failure raises (non-zero exit, no
final line). Before the last line come the `nvidia-smi` line and the
`kernels` line; the last line is the device summary.

Imports nothing of JAX, mhc_tpu or the reference's bench.
"""

from __future__ import annotations

import concurrent.futures
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
# mhc_tpu.api.compress(bench.make_corpus(100 << 20), mode="huffman"):
REF_ORDER0_100MB_LEN = 96_102_412
REF_ORDER0_100MB_SHA256 = ("1b6cb2a06fb5998b21389a05f2fdf9a5"
                           "7b368c9eb138d3b926a3ea7ffe2ef6ab")
# mhc_tpu.api.compress(bench.make_corpus(100 << 20), decode_unit=65536):
REF_100MB_DU64K_LEN = 83_792_755
REF_100MB_DU64K_SHA256 = ("77617ae59c134f39513a8984a5e1ff3b"
                          "0f2d1d0b4eb3c93aa28e37417cc0751c")
# mhc_tpu.api.compress_file of the same corpus with segment_size=32 MiB
# (4 chained containers):
REF_100MB_SEG32M_LEN = 77_223_411
REF_100MB_SEG32M_SHA256 = ("3c1cf61d668bc69f88cbd09efb54a7ee"
                           "2e86e79267f9d3b94a438e15725548e7")
# the same for bench.make_corpus(4 << 20) (checked by the CPU tests)
REF_4MB_SHA256 = ("54f0867e82f83dd27606e1a1df827687"
                  "846701316e48a2dc56f0a09f274bcc86")
TIMED_REPS = 3
KERNEL_BATCH = 10                # kernel and library calls per timed run
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)

# launch-counter name -> (source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "markov_hist": ("histogram.cu",
                    "mhc_tpu/ops/kernels/histogram_pallas.py:98"),
    "order0_hist": ("histogram.cu",
                    "mhc_tpu/ops/kernels/histogram_pallas.py:167"),
    "pack_units": ("encode.cu", "mhc_tpu/ops/kernels/encode_pallas.py:711"),
    "lookup_cl": ("encode.cu", "mhc_tpu/ops/kernels/lookup_pallas.py:278"),
    "pack_cl": ("encode.cu", "mhc_tpu/ops/kernels/encode_pallas.py:291"),
    "bubble_pack": ("encode.cu",
                    "mhc_tpu/ops/kernels/encode_pallas.py:375"),
    "decode_units": ("decode.cu",
                     "mhc_tpu/ops/kernels/decode_pallas.py:857"),
    "decode_units_order0": ("decode.cu",
                            "mhc_tpu/ops/kernels/decode_pallas.py:845"),
    # K7's decode table, built on the card for the decode kernel
    "decode_lut": ("decode.cu", "mhc_tpu/ops/kernels/decode_pallas.py:857"),
    "decode_lut_order0": ("decode.cu",
                          "mhc_tpu/ops/kernels/decode_pallas.py:845"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def min_ms(torch, fn, reps: int, batch: int = 1):
    """(last result, ms per call): the minimum over `reps` runs of `batch`
    calls back to back, after one warm-up call, CUDA events around each
    run. A batch keeps the host's enqueue time of one call out of a short
    kernel's time."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            out = fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / batch)
    return out, best


def max_abs_err(a, b) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def coded_bytes(bits, rows=None) -> int:
    """Bytes of the coded words of each unit (of `rows`, a mask): what a
    packer writes or a decoder reads for this run's data."""
    words = (bits.long() + 31) // 32
    return 4 * int((words if rows is None else words[rows]).sum())


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build(names) -> None:
    """One nvcc per source, all started together."""
    from mhc_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    for name in names:
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            ptxas = [ln.strip() for ln in f
                     if "registers" in ln or "spill" in ln]
        emit("build", kernel=name, source=_build.source(name), ptxas=ptxas)
    emit("build", all_seconds=round(time.perf_counter() - t0, 3))


def compare(torch, rows: dict, name: str, kern, plain, reps: int,
            plain_reps: int, inputs: str = "markov", bound_bytes=None,
            library=None, symbols_per_unit=None):
    """Kernel `name` vs its plain version on one path's inputs
    ("markov", "payload_route" or "order0"), tolerance 0; records the comparison in the
    kernel's row and returns the kernel's outputs. bound_bytes(outputs)
    gives the bytes the function must move; `library` is one PyTorch call
    computing the same function (timed only); symbols_per_unit gives the
    ns per symbol of one unit's chain. A kernel that both paths run (K3)
    is held on each path's inputs: its row's numbers are the first
    path's, its max_abs_err the largest, and `on_inputs` has each
    comparison."""
    got, ms = min_ms(torch, kern, reps, KERNEL_BATCH)
    ref, plain_ms = min_ms(torch, plain, plain_reps)
    got, ref = as_tuple(got), as_tuple(ref)
    err = max(max_abs_err(a, b) for a, b in zip(got, ref, strict=True))
    shapes = [list(t.shape) for t in got]
    moved = bound_bytes(got)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    library_ms = (min_ms(torch, library, reps, KERNEL_BATCH)[1] if library
                  else None)
    extra = {"bound_ms": bound_ms, "bound_by": "bytes",
             "bound_bytes": moved, "share_of_bound": bound_ms / ms,
             "library_ms": library_ms}
    if symbols_per_unit:
        extra["ns_per_symbol"] = ms * 1e6 / symbols_per_unit
    emit("kernel", kernel=name, inputs=inputs, shapes=shapes,
         max_abs_err=err, tolerance=0, ms=ms, plain_ms=plain_ms,
         plain_inputs="full shape", **extra)
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version on "
                             f"the {inputs} inputs (max abs err {err}); "
                             "tolerance is 0")
    src, replaces = KERNELS[name]
    row = rows.setdefault(name, {
        "name": name, "route": "cuda",
        "source": f"mhc_tpu_torch/csrc/{src}", "replaces": replaces,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **extra,
        "on_inputs": {}})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["on_inputs"][inputs] = {"shapes": shapes, "max_abs_err": err,
                                "ms": ms, "plain_ms": plain_ms, **extra}
    return got


def flat_index(torch, u, nv, markov: bool, past=None):
    """The int64 index a bare library call reads: prev * 256 + cur
    (Markov, prev 0 at a unit's start) or the byte; positions past
    n_valid dropped (a flat index for torch.bincount) or, with `past`,
    set to it ((R, n), for torch.take)."""
    cur = u.long()
    valid = (torch.arange(u.shape[1], device=u.device)[None, :]
             < nv[:, None])
    if markov:
        prev = torch.nn.functional.pad(cur[:, :-1], (1, 0))
        cur = prev * 256 + cur
    return cur[valid] if past is None else torch.where(valid, cur, past)


def decode_lut_checks(torch, rows: dict, t: dict, markov: bool) -> None:
    """K7's table build vs its plain version on the path's tables."""
    from mhc_tpu_torch.ops.kernels import decode_cuda
    args = (t["lim"], t["base"], t["first_code"], t["sorted_syms"])
    read = nbytes(*args) if markov else nbytes(*args) // 256
    compare(torch, rows, "decode_lut" if markov else "decode_lut_order0",
            lambda: decode_cuda.decode_lut(*args, markov=markov),
            lambda: decode_cuda.decode_lut_plain(*args, markov=markov),
            10, 3, "markov" if markov else "order0",
            bound_bytes=lambda out: read + nbytes(*out))


def cl_packers_checks(torch, rows: dict, cl, fused, inputs: str,
                      dense: bool = True) -> None:
    """K4 (with `dense`) and K6 on the cl plane of one path's inputs
    against their plain versions, and K4's words and the compacted K6's
    against K3's `fused` (words, bits) of the same units. The 419 MB
    planes of one comparison are freed before the next."""
    from mhc_tpu_torch.ops import bitpack
    from mhc_tpu_torch.ops.kernels import encode_cuda
    if dense:
        split = compare(torch, rows, "pack_cl",
                        lambda: encode_cuda.pack_cl(cl),
                        lambda: encode_cuda.pack_cl_plain(cl), 5, 2, inputs,
                        bound_bytes=lambda out: (nbytes(cl, out[1])
                                                 + coded_bytes(out[1])))
        same = all(torch.equal(a, b)
                   for a, b in zip(split, fused, strict=True))
        emit("kernel", check="pack_cl(lookup_cl(x)) == pack_units(x)",
             inputs=inputs, words_and_bits_equal=same)
        if not same:
            raise AssertionError(f"K4(K5(x)) differs from K3(x) on the "
                                 f"{inputs} inputs")
        del split
    bubbles = compare(torch, rows, "bubble_pack",
                      lambda: encode_cuda.bubble_pack(cl),
                      lambda: encode_cuda.bubble_pack_plain(cl), 5, 1, inputs,
                      bound_bytes=lambda out: nbytes(cl, *out))
    words = bitpack.compact_bubbles(*bubbles, fused[0].shape[1])
    same = torch.equal(words, fused[0]) and torch.equal(bubbles[3], fused[1])
    emit("kernel", check="compact_bubbles(bubble_pack(lookup_cl(x))) == "
         "pack_units(x)", inputs=inputs, words_and_bits_equal=same)
    if not same:
        raise AssertionError("the compacted K6(K5(x)) differs from K3(x) "
                             f"on the {inputs} inputs")


def phase_kernels_markov(torch, data: bytes, dev, rows: dict) -> None:
    """K1, K3, K5, K4, K6 and K7m against their plain versions on the
    Markov main path's inputs."""
    from mhc_tpu_torch import engine
    from mhc_tpu_torch.models.entropy import MARKOV
    from mhc_tpu_torch.ops.kernels import (decode_cuda, encode_cuda,
                                           histogram_cuda)
    st = engine.stage(data, device=dev)
    u, nv = st.units, st.n_valid
    idx = flat_index(torch, u, nv, True)
    (counts,) = compare(
        torch, rows, "markov_hist",
        lambda: histogram_cuda.markov_hist(u, nv),
        lambda: histogram_cuda.markov_hist_plain(u, nv), 10, 3,
        bound_bytes=lambda out: nbytes(u, nv, *out),
        library=lambda: torch.bincount(idx, minlength=65536))
    del idx
    lengths = MARKOV.lengths_from_counts(counts.cpu().numpy())
    t = MARKOV.tables_from_lengths(lengths, dev)
    tab = (t["codes"], t["lengths"])
    n = u.shape[1]
    fused = compare(torch, rows, "pack_units",
                    lambda: encode_cuda.pack_units(u, nv, *tab),
                    lambda: encode_cuda.pack_units_plain(u, nv, *tab), 5, 2,
                    bound_bytes=lambda out: (nbytes(u, nv, *tab, out[1])
                                             + coded_bytes(out[1])),
                    symbols_per_unit=n)
    # K5 as one gather: the (len << 16 | code) table with a 0 entry at
    # 65536, where the positions past n_valid point
    cl_table = torch.cat([(t["lengths"] << 16 | t["codes"]).reshape(-1),
                          torch.zeros(1, dtype=torch.int32, device=dev)])
    idx = flat_index(torch, u, nv, True, past=65536)
    (cl,) = compare(torch, rows, "lookup_cl",
                    lambda: encode_cuda.lookup_cl(u, nv, *tab),
                    lambda: encode_cuda.lookup_cl_plain(u, nv, *tab), 5, 2,
                    bound_bytes=lambda out: nbytes(u, nv, *tab, *out),
                    library=lambda: torch.take(cl_table, idx))
    same = torch.equal(torch.take(cl_table, idx), cl)
    emit("kernel", check="torch.take(cl table, index) == lookup_cl(x)",
         equal=same)
    if not same:
        raise AssertionError("K5's library call differs from K5")
    del idx
    cl_packers_checks(torch, rows, cl, fused, "markov")
    del cl, fused
    enc = engine.encode(st, lengths=lengths)
    words, n_dec, _, t = engine.decode_inputs(enc)
    du = enc.decode_unit
    decode_lut_checks(torch, rows, t, True)
    dec_args = (words, n_dec, t["lim"], t["base"], t["first_code"],
                t["sorted_syms"])
    read = (coded_bytes(torch.from_numpy(enc.bit_lens), n_dec.cpu() > 0)
            + nbytes(*dec_args[1:]))
    compare(torch, rows, "decode_units",
            lambda: decode_cuda.decode_units(*dec_args, n_out=du),
            lambda: decode_cuda.decode_units_plain(*dec_args, n_out=du),
            5, 1, bound_bytes=lambda out: read + nbytes(*out),
            symbols_per_unit=du)


def phase_kernels_payload_route(torch, data: bytes, dev, rows: dict) -> None:
    """K5 -> K4 and K5 -> K6 against their plain versions on the payload
    route's inputs: Markov, 1,600 units of 64 KB."""
    from mhc_tpu_torch import engine
    from mhc_tpu_torch.models.entropy import MARKOV
    from mhc_tpu_torch.ops.kernels import encode_cuda
    torch.cuda.empty_cache()
    st = engine.stage(data, decode_unit=65536, device=dev)
    u, nv = st.units, st.n_valid
    t = MARKOV.tables_from_lengths(
        MARKOV.lengths_from_counts(engine.histogram(st)), dev)
    tab = (t["codes"], t["lengths"])
    fused = encode_cuda.pack_units(u, nv, *tab)
    cl = encode_cuda.lookup_cl(u, nv, *tab)
    cl_packers_checks(torch, rows, cl, fused, "payload_route")


def phase_kernels_order0(torch, data: bytes, dev, rows: dict) -> None:
    """K2, K3, K6 and K7o against their plain versions on the order-0
    path's inputs (K3 and K5 with the broadcast order-0 tables)."""
    from mhc_tpu_torch import engine
    from mhc_tpu_torch.models.entropy import ORDER0
    from mhc_tpu_torch.ops.kernels import (decode_cuda, encode_cuda,
                                           histogram_cuda)
    st = engine.stage(data, mode="huffman", device=dev)
    u, nv = st.units, st.n_valid
    idx = flat_index(torch, u, nv, False)
    (counts,) = compare(
        torch, rows, "order0_hist",
        lambda: histogram_cuda.order0_hist(u, nv),
        lambda: histogram_cuda.order0_hist_plain(u, nv), 10, 3, "order0",
        bound_bytes=lambda out: nbytes(u, nv, *out),
        library=lambda: torch.bincount(idx, minlength=256))
    del idx
    lengths = ORDER0.lengths_from_counts(counts.cpu().numpy())
    t = ORDER0.tables_from_lengths(lengths, dev)
    tab = (t["codes"], t["lengths"])
    fused = compare(
        torch, rows, "pack_units",
        lambda: encode_cuda.pack_units(u, nv, *tab),
        lambda: encode_cuda.pack_units_plain(u, nv, *tab), 5, 2,
        "order0", bound_bytes=lambda out: (nbytes(u, nv, *tab, out[1])
                                           + coded_bytes(out[1])),
        symbols_per_unit=u.shape[1])
    cl = encode_cuda.lookup_cl(u, nv, *tab)
    cl_packers_checks(torch, rows, cl, fused, "order0", dense=False)
    del cl, fused
    torch.cuda.empty_cache()
    enc = engine.encode(st, lengths=lengths)
    words, n_dec, _, t = engine.decode_inputs(enc)
    du = enc.decode_unit
    decode_lut_checks(torch, rows, t, False)
    dec_args = (words, n_dec, t["lim"], t["base"], t["first_code"],
                t["sorted_syms"])
    # order-0 reads row 0 of each table
    read = (coded_bytes(torch.from_numpy(enc.bit_lens), n_dec.cpu() > 0)
            + nbytes(n_dec) + nbytes(*dec_args[2:]) // 256)
    compare(torch, rows, "decode_units_order0",
            lambda: decode_cuda.decode_units(*dec_args, n_out=du,
                                             markov=False),
            lambda: decode_cuda.decode_units_plain(*dec_args, n_out=du,
                                                   markov=False),
            5, 1, "order0", bound_bytes=lambda out: read + nbytes(*out),
            symbols_per_unit=du)


def run_counted(torch, fn):
    """fn() with the launch counters set to 0 just before and read just
    after; returns (fn's result, {kernel: launches})."""
    from mhc_tpu_torch.ops.kernels import _build
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: _build.LAUNCHES[k] for k in KERNELS}


def require_launches(path: str, launches: dict, want: dict) -> None:
    """want: kernel -> "once" (exactly 1), "some" (>= 1) or "none" (0)."""
    ok = {"once": lambda n: n == 1, "some": lambda n: n >= 1,
          "none": lambda n: n == 0}
    bad = {k: launches[k] for k, rule in want.items()
           if not ok[rule](launches[k])}
    if bad:
        raise AssertionError(f"{path}: launches {bad} break {want}")


def check_container(path: str, blob: bytes, ref_len: int,
                    ref_sha: str) -> str:
    digest = hashlib.sha256(blob).hexdigest()
    if len(blob) != ref_len or digest != ref_sha:
        raise AssertionError(
            f"{path}: container ({len(blob)} B, {digest}) differs from the "
            f"JAX reference's ({ref_len} B, {ref_sha})")
    return digest


def round_trip(torch, data: bytes, mode: str, dev, path: str,
               want: dict, ref_len: int, ref_sha: str):
    """One path end to end through the engine, counted, then timed;
    returns (container, launches)."""
    from mhc_tpu_torch import api, engine
    from mhc_tpu_torch.ops import bitpack
    from mhc_tpu_torch.utils import native
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def drive():
        st = engine.stage(data, mode=mode, device=dev)
        enc = engine.encode(st)
        return st, enc, engine.decode(enc)

    (st, enc, out), launches = run_counted(torch, drive)
    if engine.fetch_bytes(enc, out) != data:
        raise AssertionError(f"{path}: round trip is not bit-exact")
    require_launches(path, launches, want)
    del out
    _, enc_ms = min_ms(torch, lambda: engine.encode(st), TIMED_REPS)
    _, dec_ms = min_ms(torch, lambda: engine.decode(enc), TIMED_REPS)
    peak = torch.cuda.max_memory_allocated()

    crc = zlib.crc32(data) & 0xFFFFFFFF
    blob = engine.assemble_container(enc, crc)
    raw = int(bitpack.raw_unit_mask(enc.byte_lens, st.n_valid.cpu().numpy(),
                                    enc.aligned).sum())
    emit(path, mode=mode, n_bytes=len(data), n_units=enc.n_units,
         decode_unit=enc.decode_unit, literal_units=raw, launches=launches,
         table_builder="native C++" if native.available() else "numpy",
         encode_ms=enc_ms, decode_ms=dec_ms,
         encode_GBps=len(data) / enc_ms / 1e6,
         decode_GBps=len(data) / dec_ms / 1e6,
         container_bytes=len(blob), ratio=len(blob) / len(data),
         sha256=hashlib.sha256(blob).hexdigest(), peak_device_bytes=peak)
    check_container(path, blob, ref_len, ref_sha)
    if api.compress(data, mode=mode, device=dev) != blob:
        raise AssertionError(f"{path}: api.compress wrote other bytes")
    if api.decompress(blob, device=dev) != data:
        raise AssertionError(f"{path}: api.decompress did not return "
                             "the input")
    emit("decompress", path=path, ok=True)
    return blob, launches


def phase_split_path(torch, data: bytes, dev, pack_method: str,
                     want: dict) -> dict:
    """Markov 100 MB through engine.encode(pack_method="dense" or
    "pallas"), counted, then timed in turns with the fused encode."""
    from mhc_tpu_torch import engine
    path = f"{pack_method}_path"
    torch.cuda.empty_cache()
    st = engine.stage(data, device=dev)
    enc, launches = run_counted(
        torch, lambda: engine.encode(st, pack_method=pack_method))
    require_launches(path, launches, want)
    # the two encodes timed in turns, so that they compare within one
    # call: minimum over the turns of each
    ms = {"fused": float("inf"), pack_method: float("inf")}
    for turn in ("fused", pack_method, pack_method, "fused") * 2:
        _, t = min_ms(torch, lambda: engine.encode(st, pack_method=turn), 1)
        ms[turn] = min(ms[turn], t)
    blob = engine.assemble_container(enc, zlib.crc32(data) & 0xFFFFFFFF)
    emit(path, n_bytes=len(data), launches=launches,
         encode_ms=ms[pack_method],
         encode_GBps=len(data) / ms[pack_method] / 1e6,
         fused_encode_ms_in_turns=ms["fused"], container_bytes=len(blob),
         sha256=hashlib.sha256(blob).hexdigest())
    check_container(path, blob, REF_100MB_LEN, REF_100MB_SHA256)
    return launches


def phase_payload_route(torch, data: bytes, dev) -> bytes:
    """Markov 100 MB with decode_unit == block_size through
    pack_method="pallas": K6's bubble stream straight to the payload.
    Returns the container."""
    from mhc_tpu_torch import engine
    torch.cuda.empty_cache()

    def drive():
        st = engine.stage(data, decode_unit=65536, device=dev)
        enc = engine.encode(st, pack_method="pallas")
        return st, enc, engine.decode(enc)

    (st, enc, out), launches = run_counted(torch, drive)
    require_launches("payload_route", launches,
                     {"lookup_cl": "once", "bubble_pack": "once",
                      "pack_units": "none", "pack_cl": "none",
                      "decode_lut": "once", "decode_units": "once"})
    if engine.fetch_bytes(enc, out) != data:
        raise AssertionError("payload_route: round trip is not bit-exact")
    del out
    _, enc_ms = min_ms(
        torch, lambda: engine.encode(st, pack_method="pallas"), TIMED_REPS)
    _, dec_ms = min_ms(torch, lambda: engine.decode(enc), TIMED_REPS)
    blob = engine.assemble_container(enc, zlib.crc32(data) & 0xFFFFFFFF)
    emit("payload_route", n_bytes=len(data), n_units=enc.n_units,
         decode_unit=enc.decode_unit, launches=launches, encode_ms=enc_ms,
         decode_ms=dec_ms, container_bytes=len(blob),
         sha256=hashlib.sha256(blob).hexdigest())
    check_container("payload_route", blob, REF_100MB_DU64K_LEN,
                    REF_100MB_DU64K_SHA256)
    return blob


def phase_order0_pallas(torch, data: bytes, dev) -> None:
    """Order-0 100 MB through api.compress(pack_method="pallas")."""
    from mhc_tpu_torch import api
    torch.cuda.empty_cache()
    blob, launches = run_counted(torch, lambda: api.compress(
        data, mode="huffman", device=dev, pack_method="pallas"))
    require_launches("order0_pallas", launches,
                     {"order0_hist": "some", "lookup_cl": "some",
                      "bubble_pack": "some", "pack_units": "none",
                      "markov_hist": "none"})
    emit("order0_pallas", n_bytes=len(data), launches=launches,
         container_bytes=len(blob), sha256=hashlib.sha256(blob).hexdigest())
    check_container("order0_pallas", blob, REF_ORDER0_100MB_LEN,
                    REF_ORDER0_100MB_SHA256)


def wall_s(torch, fn):
    """(fn()'s result, host wall seconds of the call, synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_host_bytes(torch, data: bytes, dev) -> None:
    """The chunked api.compress / api.decompress at 100 MB, host bytes in
    and out, counted once, then timed in turns at 16 MB chunks and at
    the default chunk size."""
    from mhc_tpu_torch import api
    torch.cuda.empty_cache()
    default = api.CHUNK_BYTES
    n_chunks = len(api._chunks(-(-len(data) // api.DEFAULT_DECODE_UNIT),
                               api.DEFAULT_DECODE_UNIT))
    if n_chunks < 2:
        raise AssertionError("host_bytes: the default chunk size gives "
                             f"{n_chunks} chunk at 100 MB")
    blob, launches = run_counted(
        torch, lambda: api.compress(data, device=dev))
    require_launches("host_bytes", launches,
                     {"markov_hist": "some", "pack_units": "some"})
    check_container("host_bytes", blob, REF_100MB_LEN, REF_100MB_SHA256)
    out, dec_launches = run_counted(
        torch, lambda: api.decompress(blob, device=dev))
    if out != data:
        raise AssertionError("host_bytes: api.decompress did not return "
                             "the input")
    del out
    secs = {}
    try:
        for size in (16 << 20, default, default, 16 << 20) * 2:
            api.CHUNK_BYTES = size
            got, c = wall_s(torch, lambda: api.compress(data, device=dev))
            back, d = wall_s(torch, lambda: api.decompress(got, device=dev))
            if got != blob or back != data:
                raise AssertionError(f"host_bytes: {size}-byte chunks "
                                     "changed the bytes")
            old = secs.get(size, (float("inf"), float("inf")))
            secs[size] = (min(old[0], c), min(old[1], d))
    finally:
        api.CHUNK_BYTES = default
    emit("host_bytes", n_bytes=len(data), chunk_bytes=default,
         n_chunks=n_chunks, launches=launches, decode_launches=dec_launches,
         compress_s={str(k): v[0] for k, v in secs.items()},
         decompress_s={str(k): v[1] for k, v in secs.items()},
         compress_GBps=len(data) / secs[default][0] / 1e9,
         decompress_GBps=len(data) / secs[default][1] / 1e9,
         container_bytes=len(blob), sha256=hashlib.sha256(blob).hexdigest())


def phase_cli(corpus_path: str, data: bytes) -> None:
    """The CLI as a user runs it, in subprocesses."""
    out_dir = os.path.dirname(corpus_path)
    mhc = os.path.join(out_dir, "corpus_seg32m.mhc")
    back = os.path.join(out_dir, "corpus_back.bin")

    def cli(*args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "mhc_tpu_torch.cli", *args],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=600)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"cli {args[0]} exited {r.returncode}: "
                                 f"{r.stderr[-2000:]}")
        return r.stdout.strip().splitlines()[-1], dt

    enc_out, enc_s = cli("encode", "--segment-size", "32M", "--report",
                         corpus_path, mhc)
    with open(mhc, "rb") as f:
        blob = f.read()
    check_container("cli", blob, REF_100MB_SEG32M_LEN,
                    REF_100MB_SEG32M_SHA256)
    dec_out, dec_s = cli("decode", "--report", mhc, back)
    with open(back, "rb") as f:
        if f.read() != data:
            raise AssertionError("cli: decode did not return the input")
    stat_out, stat_s = cli("stat", mhc)
    emit("cli", encode_report=json.loads(enc_out), encode_wall_s=enc_s,
         decode_report=json.loads(dec_out), decode_wall_s=dec_s,
         stat=json.loads(stat_out), stat_wall_s=stat_s,
         container_bytes=len(blob), sha256=hashlib.sha256(blob).hexdigest())
    for p in (mhc, back):
        os.remove(p)


def phase_hybrid(torch, data: bytes, dev) -> None:
    from mhc_tpu_torch import hybrid
    torch.cuda.empty_cache()
    blob, c = wall_s(torch, lambda: hybrid.compress(
        data, host_fraction=0.5, device=dev))
    check_container("hybrid", blob, REF_100MB_LEN, REF_100MB_SHA256)
    out, d = wall_s(torch, lambda: hybrid.decompress(
        blob, host_fraction=0.5, device=dev))
    if out != data:
        raise AssertionError("hybrid: decompress did not return the input")
    emit("hybrid", n_bytes=len(data), host_fraction=0.5, compress_s=c,
         decompress_s=d, container_bytes=len(blob))


def claim_whole_payload(blob: bytes) -> bytes:
    """A container of the legacy layout (one u32 bit length per unit)
    with its index rewritten so that unit 0 claims the whole payload and
    every other unit nothing: the payload size, and so the parse, stay
    as they were."""
    import numpy as np
    from mhc_tpu_torch import container
    meta = container.parse_container(blob)
    if meta.decode_unit is not None:
        raise AssertionError("claim_whole_payload: not the legacy layout")
    index = np.zeros(meta.n_blocks, "<u4")
    index[0] = 8 * int(meta.byte_lengths.sum())
    start = meta.payload_off - meta.index_bytes
    bad = blob[:start] + index.tobytes() + blob[meta.payload_off:]
    if container.parse_container(bad).payload_off != meta.payload_off:
        raise AssertionError("claim_whole_payload: the parse changed")
    return bad


def phase_corrupt(torch, blob: bytes, data: bytes, du64k_blob: bytes,
                  dev) -> None:
    """Damaged containers decoded on the card raise ValueError, with no
    CUDA error, and the card decodes cleanly afterwards. The payload
    route's container whose unit 0 claims the whole payload (1,600 rows
    of 20.9 M words, were its length believed) raises before anything is
    allocated for it."""
    from mhc_tpu_torch import api, container
    meta = container.parse_container(blob)
    flipped = bytearray(blob)
    flipped[meta.payload_off + int(meta.byte_lengths.sum()) // 2] ^= 0x10
    cases = {"payload_bit_flip": (bytes(flipped), "crc32"),
             "truncated": (blob[: len(blob) // 2], "truncated"),
             "bad_magic": (b"MHTX" + blob[4:], "magic")}
    seen = {}
    for name, (bad, want) in cases.items():
        try:
            api.decompress(bad, device=dev)
        except ValueError as e:
            if want not in str(e):
                raise AssertionError(f"corrupt {name}: {e}") from e
            seen[name] = str(e)
        else:
            raise AssertionError(f"corrupt {name}: decoded without error")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.max_memory_allocated()
    try:
        api.decompress(claim_whole_payload(du64k_blob), device=dev)
    except ValueError as e:
        if "unit length" not in str(e):
            raise AssertionError(f"corrupt unit_claims_payload: {e}") from e
        seen["unit_claims_payload"] = str(e)
    else:
        raise AssertionError("corrupt unit_claims_payload: decoded without "
                             "error")
    torch.cuda.synchronize()
    after = torch.cuda.max_memory_allocated()
    if after - before > 1 << 20:
        raise AssertionError(f"corrupt unit_claims_payload: {after - before}"
                             " bytes were allocated before the error")
    if api.decompress(blob, device=dev) != data:
        raise AssertionError("corrupt: the clean decode afterwards failed")
    emit("corrupt", errors=seen, clean_decode_after=True,
         unit_claims_payload_max_memory_allocated={"before": before,
                                                   "after": after})


def phase_oracle(blobs: dict, corpus_path: str) -> None:
    """blobs: oracle mode ("em" or "e0") -> the port's container."""
    r = subprocess.run(["make", "-C", os.path.join(REPO, "oracle")],
                       capture_output=True, text=True, timeout=300)
    exe = os.path.join(REPO, "oracle", "mh_oracle")
    if r.returncode != 0 or not os.path.exists(exe):
        raise AssertionError(f"make -C oracle failed (exit {r.returncode}):"
                             f" {(r.stdout + r.stderr)[-2000:]}")
    for mode, blob in blobs.items():
        res = subprocess.run([exe, "bench", mode, corpus_path],
                             capture_output=True, text=True, timeout=600,
                             check=True)
        ref = json.loads(res.stdout.strip())
        emit("oracle", mode=mode, oracle=ref, container_bytes=len(blob),
             vs_oracle=len(blob) / ref["compressed_bytes"])
        if len(blob) > ref["compressed_bytes"]:
            raise AssertionError(f"{mode} container is larger than the "
                                 "oracle's")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs only on a CUDA GPU")
    sys.path.insert(0, REPO)
    from mhc_tpu_torch.ops.kernels import _build
    from mhc_tpu_torch.utils.corpus import make_corpus
    smi = phase_device(torch)
    phase_build(("histogram", "encode", "decode"))
    dev = torch.device("cuda:0")
    data = make_corpus(CORPUS_BYTES)
    rows: dict = {}
    phase_kernels_markov(torch, data, dev, rows)
    phase_kernels_payload_route(torch, data, dev, rows)
    phase_kernels_order0(torch, data, dev, rows)
    markov_blob, launches = round_trip(
        torch, data, "markov", dev, "main_path",
        {"markov_hist": "once", "pack_units": "once", "decode_lut": "once",
         "decode_units": "once"}, REF_100MB_LEN, REF_100MB_SHA256)
    dense_launches = phase_split_path(
        torch, data, dev, "dense",
        {"lookup_cl": "once", "pack_cl": "once", "pack_units": "none"})
    pallas_launches = phase_split_path(
        torch, data, dev, "pallas",
        {"lookup_cl": "once", "bubble_pack": "once", "pack_units": "none",
         "pack_cl": "none"})
    du64k_blob = phase_payload_route(torch, data, dev)
    order0_blob, order0_launches = round_trip(
        torch, data, "huffman", dev, "order0_path",
        {"order0_hist": "some", "pack_units": "some",
         "decode_lut_order0": "some", "decode_units_order0": "some",
         "markov_hist": "none"},
        REF_ORDER0_100MB_LEN, REF_ORDER0_100MB_SHA256)
    phase_order0_pallas(torch, data, dev)
    phase_host_bytes(torch, data, dev)
    corpus_path = os.path.join(_build.BUILD_DIR, "corpus_100mb.bin")
    with open(corpus_path, "wb") as f:
        f.write(data)
    phase_cli(corpus_path, data)
    phase_hybrid(torch, data, dev)
    phase_corrupt(torch, markov_blob, data, du64k_blob, dev)
    phase_oracle({"em": markov_blob, "e0": order0_blob}, corpus_path)
    # each kernel's launches on the path that runs it (K3: the main path;
    # the order-0 path's launches are in its own line)
    path_of = {"order0_hist": order0_launches,
               "decode_units_order0": order0_launches,
               "decode_lut_order0": order0_launches,
               "lookup_cl": dense_launches, "pack_cl": dense_launches,
               "bubble_pack": pallas_launches}
    for name, row in rows.items():
        row["launches"] = path_of.get(name, launches)[name]
    if set(rows) != set(KERNELS):
        raise AssertionError(f"kernels unchecked: {set(KERNELS) - set(rows)}")
    print(smi, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
