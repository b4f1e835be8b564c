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
     times (the kernel and the library call: `ms` per call over runs of
     10 back to back, the host's enqueue in; `device_ms` and
     `library_device_ms` the same 10 calls captured in a CUDA graph and
     replayed, the device's time alone, null with its reason where a
     call cannot be captured; the plain version: single calls; minimum
     over the runs), the bound (the bytes the function must move over
     3.35 TB/s,
     coded words counted as this run's bits give them; K11's chain floor
     beside it) and the library call over a prepared index
     (K1 and K2: a bare `torch.bincount`; K5: one `torch.take`, checked
     equal to K5): first K11 (the device table build) == its plain
     version == the host build on corner rows (all zero, one symbol, two
     symbols, all 256 equal, Fibonacci rows that need the 15-bit repair,
     int64 totals over 2**31, random rows; int32 and int64 counts), and
     the fused table build (K11 and K13's bodies in one launch) == its
     plain version on the same rows; then
     K1, K11 (its chain floor and the host build's ms beside it), the
     fused table build (== K11 then K13, and timed in turns against
     them), K3,
     K5, K4, K6, K15's rows of K6's stream, K7's table build and K7m
     on the Markov inputs (12,800 units of 8 KB), with K4(K5(x)) and
     K15(K6(K5(x))) == K3(x); K4, K6 and K15 again on the payload route's
     inputs (1,600 units of 64 KB), with the same two checks and K15's
     payload; K2, K11, the fused build (timed in turns against K11 then
     K13: order-0's 256 blocks build one row), K3, K6 and K15 (again, in
     the same rows), K7's order-0 table build and
     K7o on the order-0 inputs (6,400 units of 16 KB); on both paths'
     inputs the engine's stage kernels (`stage_checks`): K13 on the
     path's lengths (with the floor of a launch on its grid, an empty
     kernel timed the same ways), K10+K8 on K3's rows with the host's
     literal plan
     (its library call, one torch.masked_select over the substituted
     plane, checked equal), K9 on the engine's payload (its library
     call, one torch.take over a prepared index, checked equal), K12 on
     the order-0 container's parsed byte payload, K14 on K7's rows
  4. main path (Markov): engine.stage -> encode (the table build on
     the card) -> decode -> fetch_bytes with the launch counters reset
     before and read after (K1, the fused table build, K3, K7's table
     build, K7m, K10+K8, K9, K13 and K14 once each; K11 alone never);
     bit-exact round trip; container
     size and sha256 equal to the JAX reference's; the host table build's encode (the counts fetched,
     the native builder, the lengths passed in) counted (K11 and the
     fused build never, K13 once) writes it too; the two encodes timed in turns; the container decodes
     through api.decompress; encode and decode GB/s
  5. dense and pallas paths: the same Markov input through engine.encode
     with pack_method="dense" (K5 then K4) and "pallas" (K5 then K6, the
     bubble stream compacted into rows by K15), K3 never launched; the
     same container;
     encode GB/s, each timed in turns with the fused encode
  6. payload route: Markov with 64 KB decode units (== blocks, no
     literal units) through pack_method="pallas", whose bubble stream
     goes straight to the payload (K15); the JAX reference's container for
     that unit size; bit-exact round trip through engine.decode
  7. order-0 path: engine.stage(mode="huffman") -> encode -> decode ->
     fetch_bytes, counters and table builds as in 4 (K2, the fused
     build, K3, the order-0 table build and K7o launched, K1 not);
     bit-exact; the JAX reference's container; api.compress writes it and
     api.decompress reads it; encode and decode GB/s; then api.compress
     with pack_method="pallas" (K5, K6, K15's rows) writes it too
  breakdown: the engine's stages at 100 MB with the device table build,
     both modes (host clock between synchronisations, minimum of 4):
     histogram, the table builds (the fused device build; K11 alone; the
     host build, alone and followed by K13; K13 alone), K3, the bits
     fetch with
     the literal plan and K10+K8 (`engine.compact`), `decode_inputs`
     (K13, one upload, K9), K7 with its table build, K14; the host
     build beside it, and the device's idle share over one encode +
     decode (torch.profiler); one `lengths_for` call counted (K11 alone)
  redesign_turns: this slice's two redesigns against what they replace,
     in turns at 100 MB (CUDA events): the encode with the fused table
     build vs with K11's lengths passed in (K13 then builds the tables),
     both modes; the "pallas" rows route and the payload route with K15
     vs with the plain compactions
  small: 1 MB of the corpus as one block (BASELINE configs 1-2), both
     modes: the device and the host table build each counted and writing
     the JAX reference's container, timed in turns through engine.encode
     (the measurements behind `EntropyModel.lengths_for`), and
     api.compress timed
  param_grid: the container's parameter grid (`utils.corpus.grid_inputs`
     and `grid_cases`: 7 inputs from empty to 300,001 bytes, both modes,
     block sizes 1 B to 1 MiB, every decode unit the port accepts, crc on
     and off; the digests of `corpus.GRID_TABLE`, written by the JAX
     reference and held to it by tests/test_torch_param_grid.py) on the
     card: each case through api.compress with each pack method and
     api.decompress, and on block sizes 1, 16 and 64 KB through hybrid
     (0.5), the sharded pipeline on a world of one and the file functions
     (chained 100,000-byte segments); every container's length and
     sha256 the table's, every decode its input, the codec and stage
     kernels each launched (units of 1 and 2 bytes and widths off 16
     bytes take each kernel's scalar branch); the cases per route, the
     launches, the phase's seconds and the 300,001 units of the corpus
     at block_size 1 timed
  8. host bytes: the chunked api.compress / api.decompress (at least two
     chunks, the fused table build once, its tables handed to every
     chunk: K13 never), host bytes in and out, the reference container,
     timed in turns at 16 MB chunks and at the default `api.CHUNK_BYTES`
  9. CLI: api.compress_file / decompress_file in this process, counted
     (the stage kernels launched), then `python -m mhc_tpu_torch.cli`
     encode (32 MB segments: a chain of 4 containers equal to
     mhc_tpu.api.compress_file's), decode (equal to the input), stat;
     wall seconds of each
  10. hybrid: hybrid.compress / decompress at host_fraction 0.5,
     counted (the host build: K13 and K10+K8 once; K13, K9 and K14 on
     decode), the
     reference container, bit-exact, wall seconds
  sharded: parallel.pipeline.compress_sharded / decompress_sharded at
     100 MB, each rank a subprocess (`--sharded-rank`, FileStore): one
     NCCL rank (Markov), then two gloo ranks sharing cuda:0 (Markov and
     order-0); every rank's container is the reference's and round-trips,
     its stage kernels launched; wall seconds; scaling unmeasured (one
     card)
  11. corrupt containers on the card: a payload bit flip, a truncation
     and a bad magic each raise ValueError, and so does the payload
     route's container with its length index rewritten so that unit 0
     claims the whole payload, before anything is allocated for it
     (`torch.cuda.max_memory_allocated()` printed before and after), and
     each crafted container of `crafted_containers` (over-full code
     lengths in both modes, a negative unit length, an orig_len of 128 MB
     with no payload, units under their fewest bytes, a payload size
     past 2**63); F5's containers (`f5_containers`, through api and
     hybrid: du_log2 40, 63, 64 and 200 and a block size of 0 refused
     before any launch, a legacy block size of 2**31 and 2**32 - 1
     decoded with K7 at n_out 528; each within 1 MiB of peak
     allocation) and the writers' block sizes 0 and 2**32 (refused before
     any launch); then a clean decode works
  12. oracle: `make -C oracle` builds the single-core C++ oracle (a
     failed build fails the run), and each container is no larger than
     the oracle's (em for Markov, e0 for order-0)
  13. serve: the codec service in this process on cuda:0
     (`serve.make_server`, served from a thread, after a timed
     `serve.warmup`), its clients over urllib: /compress of the 100 MB
     corpus in both modes (the reference containers) and /decompress of
     each (the corpus), the Markov pair counted (K1 and K3 once per
     chunk, the fused table build once and K13 never; K7m, its table
     build and K13 once per chunk); eight
     concurrent 1 MB clients (4 Markov, 4 order-0, one 1 MB block; the
     1 MB references); a garbage container (400); /healthz; /stats
     counting every request and the one error; each request's client
     wall time beside its X-MHC-Seconds
  14. serve_cli: `python -m mhc_tpu_torch.serve --port 0` in a
     subprocess: its warm-up and bound port read from its output,
     /healthz and a 1 MB round trip, SIGINT ends it with exit 0; the
     wall time to `listening on`; then the same command with no card
     visible exits non-zero with `resolve_device`'s message
  15. trace: api.compress / api.decompress of the 100 MB Markov corpus
     with MHC_TRACE=1 and without, in turns: the reference container
     either way; the traced phases, their sum beside the traced call's
     wall, and the untraced call's wall
  16. profile: `utils.metrics.torch_profile` around two engine.encode +
     decode passes at 100 MB (Markov): the trace file names K1, the fused
     table build, K3, K7's table build, K7m, K13, K10+K8, K9 and K14 by
     their `__global__`
     names, with each one's device time and how many of its launches
     the trace holds (torch.profiler loses a window's first kernels in
     an aged process)
  17. dryrun: `python -m mhc_tpu_torch.parallel.dryrun --ranks 1` (NCCL
     on cuda:0, the default on a card) and `--ranks 2 --backend gloo`
     (two ranks sharing cuda:0) exit 0
  18. probes: the calibration probes P1-P3 (csrc/probes.cu, built in
     phase 2, whose SASS must hold IGMMA / HGMMA (wgmma) and no IMMA /
     HMMA in the fetch cores, IGMMA and no IMMA in P2, and LDS / STS in
     P1's scratch body: counts on the `build` line): every body's kernel
     == its plain version at 1 and 64 steps and at the reference's steps
     (tolerance 0; the plain versions at the reference's steps computed
     on the CPU by a worker process started after the build, `chip_smoke.py
     --reference-plains OUT`), P2 also == torch._int_mm
     (the library column) == an int64 product, and once at 4096^3 ==
     torch._int_mm, timed beside it (not gated); each loop body timed
     (ms and device_ms) at the reference's steps, with
     its bound (probe_bound), and its loop's clock64() cycles growing 4x
     at least from a sixteenth of those steps; then `python -m
     mhc_tpu_torch.bench.loop_calib`, `.mosaic_probe` and `.vpu_probe` in
     subprocesses (their JSON lines; every body launched; each chk the
     kernel's); the loop fit and the fetch-vs-pick times on one line
  multigb: BASELINE config 5 at its real size, 2**31 + 2**28 + 12,345
     bytes: the 100 MB corpus tiled to it (utils.corpus.tiled_corpus)
     through `python -m mhc_tpu_torch.bench.multigb` at 1024 and 256 MB
     segments (subprocesses: round trips exact, the chains the JAX
     reference's digests, the 256 MB run's peak RSS over its process's
     base under the file's size); then the engine past 2**31 bytes,
     counted and timed: the tiled corpus (Markov, == api.compress), zeros
     in both modes (F7: engine.histogram == the native host counts, N in
     one cell; the container == hybrid at host_fraction 1.0 and 0.0) and
     seeded noise (order-0, every unit literal, == api.compress)
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
# mhc_tpu.api.compress(bench.make_corpus(1 << 20), block_size=1 << 20)
# (BASELINE configs 1-2 at 1 MB; one block), Markov and order-0:
REF_1MB_LEN = 558_638
REF_1MB_SHA256 = ("83ed79a55b4b386cb5bf938e37c55a02"
                  "b827e3d62490abad179b521de9755b1d")
REF_ORDER0_1MB_LEN = 945_766
REF_ORDER0_1MB_SHA256 = ("f7791a830dcf2a69cf9f020dc94f4a16"
                         "e89f9215f15e2b41f203f854f42ea37d")
# BASELINE config 5 at its real size (phase multigb): 2**31 + 2**28 +
# 12,345 bytes, past every 2**31 of the kernels' row counts, byte totals
# and counts, with a tail off every block and unit boundary; the corpus is
# utils.corpus.tiled_corpus(MULTIGB_BYTES) (the 100 MB corpus repeated)
MULTIGB_BYTES = (1 << 31) + (1 << 28) + 12_345
# mhc_tpu.api.compress_file of that file with segment_size=1 << 30 (3
# chained containers) and 256 << 20 (10), on the CPU (JAX_PLATFORMS=cpu,
# MHC_PACK_METHOD=scatter, MHC_ENC_FETCH=padded, its cheapest CPU route,
# which writes the same bytes):
REF_MULTIGB_SEG1G_LEN = 1_889_930_058
REF_MULTIGB_SEG1G_SHA256 = ("a100b86ddcfd7d3378ea353a6031570d"
                            "0b5ce663cd8547755a16411d6a488fd9")
REF_MULTIGB_SEG256M_LEN = 1_887_484_029
REF_MULTIGB_SEG256M_SHA256 = ("a02db612036cdef319caa448f5b8ba86"
                              "a11303e2eb4bfd343bdc90ebb054aed2")
MULTIGB_NOISE_SEED = 17
# the same for bench.make_corpus(4 << 20) (checked by the CPU tests)
REF_4MB_SHA256 = ("54f0867e82f83dd27606e1a1df827687"
                  "846701316e48a2dc56f0a09f274bcc86")
TIMED_REPS = 3
KERNEL_BATCH = 10                # kernel and library calls per timed run
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
# a dependent shared-memory round trip (29 cycles, measured on an H100 at
# 1.995 GHz), at the H100 SXM's 1.98 GHz boost: a pick of a merge that
# reads its queue heads from shared memory waits on one
SMEM_CHAIN_S = 29 / 1.98e9
# an integer op's dependent latency: `int_dep_ns_per_op` of
# `python -m mhc_tpu_torch.bench.loop_calib` (the one-op chain c += c >> 1,
# one LEA.HI an op in its SASS), measured on an NVIDIA H100 80GB HBM3 at
# 700 W
INT_DEP_S = 2.0286e-9   # ~4 cycles at 1.98 GHz
# K11's merge step (csrc/huffman.cu `merge`, two picks with both queue
# heads in registers): its longest dependent chain, from one step's first
# compare to the next's, is compare, select, compare, select, select, min
K11_STEP_DEP_OPS = 6
# CUDA-core int32 ops: 64 INT32 lanes a SM (Hopper white paper) x 132 SMs
# x 1.98 GHz; tensor cores, dense (NVIDIA data sheet, H100 SXM)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TC_INT8_OPS_PER_S = 1979e12
TC_BF16_OPS_PER_S = 989e12

# the sharded phase's legs: (name, backend, ranks on cuda:0, modes)
SHARDED_LEGS = (("nccl_1_rank", "nccl", 1, "markov"),
                ("gloo_2_ranks_one_card", "gloo", 2, "markov,huffman"))

# the stage kernels each engine call launches (K14: the 100 MB corpus has
# literal units in both modes). An encode that builds its tables from the
# device's counts launches the fused table build once, and neither K11
# nor K13 alone; a decode launches K13 on the container's lengths.
DEVICE_BUILD = {"code_tables": "once", "code_lengths": "none"}
STAGES_ENCODE = {**DEVICE_BUILD, "canonical_tables": "none",
                 "compact_units": "once"}
STAGES_DECODE = {"canonical_tables": "some", "expand_units": "some",
                 "literal_rows": "some"}
STAGES_ROUND_TRIP = {**DEVICE_BUILD, "canonical_tables": "once",
                     "compact_units": "once", "expand_units": "once",
                     "literal_rows": "once"}

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
    # K11, the device table build: an XLA stage on the TPU, not Pallas;
    # alone (`EntropyModel.lengths_for`) and, with K13's body, the fused
    # table build of the encode
    "code_lengths": ("huffman.cu", "mhc_tpu/ops/huffman.py:289"),
    "code_tables": ("huffman.cu", "mhc_tpu/ops/huffman.py:289, "
                    "mhc_tpu/ops/canonical.py:27"),
    # the engine's stages, XLA stages on the TPU: K13 (canonical tables),
    # K10+K8 (literal substitution, then compaction), K9/K12 (expansion
    # of word and of byte payloads), K14 (literal rows; with the
    # jnp.where of mhc_tpu/engine.py:495 and mhc_tpu/api.py:587)
    "canonical_tables": ("tables.cu", "mhc_tpu/ops/canonical.py:27"),
    "compact_units": ("stages.cu", "mhc_tpu/ops/bitpack.py:178, :509"),
    "expand_units": ("stages.cu", "mhc_tpu/ops/bitpack.py:480, :652"),
    "literal_rows": ("stages.cu", "mhc_tpu/ops/bitpack.py:221"),
    # K15, the "pallas" routes' bubble compactions, XLA scatters on the TPU
    "compact_bubbles": ("stages.cu",
                        "mhc_tpu/ops/kernels/encode_pallas.py:514, :417"),
    "bubbles_to_payload": ("stages.cu",
                           "mhc_tpu/ops/kernels/encode_pallas.py:453"),
}
# P1-P3, the calibration probes: one entry per body, named by its launch
# counter; dep1_* is P1's one-op chain, the calibration of INT_DEP_S
PROBE_BODIES = {
    "loop_calib": ("bench/loop_calib.py:74", (
        "chain_4", "chain_32", "chain_128", "chain_512", "scratch_8",
        "store_32", "wide_1", "wide_4", "dep1_32", "dep1_512")),
    "mosaic_probe": ("bench/mosaic_probe.py:44", ("i8_matmul",)),
    "vpu_probe": ("bench/vpu_probe.py:41", (
        "null_loop", "onehot_i32cmp_i8cast_plus_pick",
        "onehot_bf16cmp_plus_pick_bf16", "onehot_16x16_i8mul_plus_pick",
        "pick256_i32", "pick256_i8mul_i32sum", "pick256_i8mul_i8sum",
        "pick256_f32", "fetch316_i8_matmul", "fetch316_bf16_matmul")),
}
KERNELS.update({f"{probe}/{body}": ("probes.cu", replaces)
                for probe, (replaces, bodies) in PROBE_BODIES.items()
                for body in bodies})


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


def graph_ms(torch, fn, reps: int, batch: int = 1):
    """(ms per call, None) on the device alone: `batch` calls of fn
    captured in one CUDA graph (the wrappers launch on the current
    stream, which capture records), the graph replayed once, then the
    minimum over `reps` replays between CUDA events, divided by the
    batch; the host's enqueue drops out. (None, reason) where the calls
    cannot be captured (a call that waits on the device from the host)."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    reason = None
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for _ in range(batch):
                fn()
        except Exception as e:      # the reason goes into the row
            reason = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        try:
            graph.capture_end()
        except Exception as e:
            reason = reason or f"{type(e).__name__}: {str(e)[:200]}"
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if reason:
        return None, reason
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / batch)
    del graph
    return best, None


def device_fields(torch, fn, reps: int, batch: int, key: str) -> dict:
    """{key: graph_ms} and, where it is null, {key + "_null_reason": why}."""
    ms, why = graph_ms(torch, fn, reps, batch)
    return {key: ms, **({f"{key}_null_reason": why} if why else {})}


def shares(bound_ms: float, ms: float, device_ms) -> dict:
    """The share of the bound by each time: `share_of_bound` (bound / ms)
    and `device_share_of_bound` (bound / device_ms; null where device_ms
    is)."""
    return {"share_of_bound": bound_ms / ms,
            "device_share_of_bound": (bound_ms / device_ms if device_ms
                                      else None)}


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

    def timed_build(name):
        start = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - start

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        seconds = dict(zip(names, pool.map(timed_build, names)))
    for name in names:
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            ptxas = [ln.strip() for ln in f
                     if "registers" in ln or "spill" in ln]
        sass = {}
        if name == "probes":
            from mhc_tpu_torch.ops.kernels import probes_cuda
            sass = probes_cuda.sass_counts()
        emit("build", kernel=name, source=_build.source(name), ptxas=ptxas,
             seconds=seconds[name], **({"sass": sass} if sass else {}))
    emit("build", all_seconds=round(time.perf_counter() - t0, 3))


def compare(torch, rows: dict, name: str, kern, plain, reps: int,
            plain_reps: int, inputs: str = "markov", bound_bytes=None,
            library=None, symbols_per_unit=None, more=None):
    """Kernel `name` vs its plain version on one path's inputs
    ("markov", "payload_route" or "order0"), tolerance 0; records the
    comparison in the kernel's row and returns the kernel's outputs. The
    kernel's and the library call's times: `ms` per call over runs of
    KERNEL_BATCH calls back to back (the host's enqueue in), `device_ms`
    the same calls replayed from a CUDA graph (graph_ms: the device's
    time alone), and `library_device_ms` likewise. bound_bytes(outputs)
    gives the bytes the function must move (no kernel here does
    arithmetic that takes longer at the card's peak rate than its bytes
    at the memory rate); `library` is one PyTorch call computing the same function (timed
    only); symbols_per_unit gives the ns per symbol of one unit's chain;
    `more` adds fields. A kernel that both paths run (K3) is held on each
    path's inputs: its row's numbers are the first path's, its
    max_abs_err the largest, and `on_inputs` has each comparison."""
    got, ms = min_ms(torch, kern, reps, KERNEL_BATCH)
    dev_ms = device_fields(torch, kern, reps, KERNEL_BATCH, "device_ms")
    ref, plain_ms = min_ms(torch, plain, plain_reps)
    got, ref = as_tuple(got), as_tuple(ref)
    err = max(max_abs_err(a, b) for a, b in zip(got, ref, strict=True))
    shapes = [list(t.shape) for t in got]
    moved = bound_bytes(got)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    library_ms = (min_ms(torch, library, reps, KERNEL_BATCH)[1] if library
                  else None)
    extra = {**dev_ms, "bound_ms": bound_ms, "bound_by": "bytes",
             "bound_bytes": moved, "library_ms": library_ms,
             **(device_fields(torch, library, reps, KERNEL_BATCH,
                              "library_device_ms") if library
                else {"library_device_ms": None})}
    extra.update(shares(bound_ms, ms, extra["device_ms"]))
    if symbols_per_unit:
        extra["ns_per_symbol"] = ms * 1e6 / symbols_per_unit
    extra.update(more or {})
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
                      dense: bool = True, payload: bool = False) -> None:
    """K4 (with `dense`) and K6 on the cl plane of one path's inputs
    against their plain versions, K15's rows of K6's bubble stream (and,
    with `payload`, its payload) against theirs, and K4's words and K15's
    rows against K3's `fused` (words, bits) of the same units. The 419
    MB planes of one comparison are freed before the next."""
    from mhc_tpu_torch.ops import bitpack
    from mhc_tpu_torch.ops.kernels import encode_cuda, stages_cuda
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
    W = fused[0].shape[1]
    none = {"library_ms_null_reason": "no one PyTorch call compacts a "
            "flagged stream into rows or at per-unit offsets"}
    (words,) = compare(
        torch, rows, "compact_bubbles",
        lambda: stages_cuda.compact_bubbles(*bubbles, W),
        lambda: bitpack.compact_bubbles(*bubbles, W), 10, 2, inputs,
        bound_bytes=lambda out: nbytes(*bubbles, *out), more=none)
    same = torch.equal(words, fused[0]) and torch.equal(bubbles[3], fused[1])
    emit("kernel", check="compact_bubbles(bubble_pack(lookup_cl(x))) == "
         "pack_units(x)", inputs=inputs, words_and_bits_equal=same)
    if not same:
        raise AssertionError("K15(K6(K5(x))) differs from K3(x) on the "
                             f"{inputs} inputs")
    del words
    if payload:
        # the streams' words: the kernel writes only those
        total = coded_bytes(bubbles[3]) // 4
        compare(torch, rows, "bubbles_to_payload",
                lambda: stages_cuda.bubbles_to_payload(*bubbles)[:total],
                lambda: bitpack.bubbles_to_payload(*bubbles)[:total], 10, 2,
                inputs, bound_bytes=lambda out: nbytes(*bubbles, *out),
                more={**none, "words_written": total,
                      "plain_zero_fill_words_dropped":
                      bubbles[0].numel() + bubbles[0].shape[0] - total})


def k11_merge_steps(counts) -> int:
    """The longest row's merge: m - 1 steps of two picks for a row of
    m >= 2 symbols (every row runs at once)."""
    m = (counts.reshape(-1, 256) > 0).sum(dim=1)
    m = m[m >= 2]
    return int(m.max()) - 1 if m.numel() else 0


def k11_chain_floor_ms(counts) -> float:
    """K11's latency floor on these counts: the longest row's merge, each
    step K11_STEP_DEP_OPS dependent integer ops at INT_DEP_S (3 a pick:
    both queue heads in registers, no shared-memory load on the chain).
    K11 is held to this floor, which lies far above its bytes bound."""
    return k11_merge_steps(counts) * K11_STEP_DEP_OPS * INT_DEP_S * 1e3


def k11_chain_floor_smem_ms(counts) -> float:
    """The floor of a merge that waits on a shared-memory round trip every
    pick (SMEM_CHAIN_S, 2 picks a step): what K11 was held to before its
    queue heads moved into registers."""
    return 2 * k11_merge_steps(counts) * SMEM_CHAIN_S * 1e3


def host_build_ms(torch, model, counts) -> float:
    """The host table build as the host route runs it: the counts fetched,
    rescaled and built by the native builder; minimum of 5 on the host
    clock."""
    best = float("inf")
    for _ in range(5):
        _, s = wall_s(torch, lambda: model.lengths_from_counts(
            counts.cpu().numpy()))
        best = min(best, s * 1e3)
    return best


def k11_checks(torch, rows: dict, model, counts, inputs: str) -> None:
    """K11 against its plain version on one path's counts, timed, with
    the host build's time beside it; its lengths must equal the host
    build's."""
    from mhc_tpu_torch.ops.kernels import huffman_cuda
    flat = counts.reshape(-1, 256).contiguous()
    floor_ms = k11_chain_floor_ms(flat)
    (lengths,) = compare(
        torch, rows, "code_lengths",
        lambda: huffman_cuda.code_lengths(flat),
        lambda: huffman_cuda.code_lengths_plain(flat), 10, 3, inputs,
        bound_bytes=lambda out: nbytes(flat, *out),
        more={"chain_floor_ms": floor_ms, "held_to": "chain_floor_ms",
              "chain_floor_smem_ms": k11_chain_floor_smem_ms(flat),
              "host_build_ms": host_build_ms(torch, model, counts)})
    chain_floor_shares(rows["code_lengths"], inputs, floor_ms)
    host = model.lengths_from_counts(counts.cpu().numpy())
    same = bool((lengths.reshape(counts.shape).cpu().numpy() == host).all())
    emit("kernel", check="code_lengths(counts) == host build",
         inputs=inputs, equal=same)
    if not same:
        raise AssertionError(f"K11 differs from the host build on the "
                             f"{inputs} counts")


def chain_floor_shares(row: dict, inputs: str, floor_ms: float) -> None:
    """A merge kernel's row (K11, the fused build) held to its chain
    floor: the shares of the floor by `ms` and `device_ms`."""
    on = row["on_inputs"][inputs]
    on["share_of_chain_floor"] = floor_ms / on["ms"]
    if on["device_ms"]:
        on["device_share_of_chain_floor"] = floor_ms / on["device_ms"]
    row.setdefault("share_of_chain_floor", on["share_of_chain_floor"])
    row.setdefault("device_share_of_chain_floor",
                   on.get("device_share_of_chain_floor"))


def code_tables_checks(torch, rows: dict, counts, inputs: str) -> None:
    """The fused table build (K11 and K13's bodies in one launch) against
    its plain version on one path's counts, held to K11's chain floor
    beside its bytes bound; then timed in turns against K11 followed by
    K13, the two launches it replaces (on order-0, one row of counts, 256
    blocks build the one row where K11 runs one block)."""
    from mhc_tpu_torch.ops.kernels import huffman_cuda, tables_cuda
    flat = counts.reshape(-1, 256).contiguous()
    floor_ms = k11_chain_floor_ms(flat)
    got = compare(
        torch, rows, "code_tables",
        lambda: as_tuple_tables(huffman_cuda.code_tables(flat, 256)),
        lambda: as_tuple_tables(huffman_cuda.code_tables_plain(flat, 256)),
        10, 3, inputs, bound_bytes=lambda out: nbytes(flat, *out),
        more={"chain_floor_ms": floor_ms, "held_to": "chain_floor_ms",
              "library_ms_null_reason": "no one PyTorch call builds "
              "Huffman code lengths or canonical tables"})
    chain_floor_shares(rows["code_tables"], inputs, floor_ms)
    split = huffman_cuda.code_lengths(flat)
    same = torch.equal(got[0], split) and all(
        torch.equal(a, b) for a, b in zip(
            got[1:], tables_cuda.canonical_tables(split, 256).values()))
    emit("kernel", check="code_tables(counts) == canonical_tables("
         "code_lengths(counts))", inputs=inputs, equal=same)
    if not same:
        raise AssertionError(f"the fused build differs from K11 then K13 "
                             f"on the {inputs} counts")
    builds = {"fused": lambda: huffman_cuda.code_tables(flat, 256),
              "k11_then_k13": lambda: tables_cuda.canonical_tables(
                  huffman_cuda.code_lengths(flat), 256)}
    ms = {k: float("inf") for k in builds}
    dev_ms = dict(ms)
    for turn in ("fused", "k11_then_k13", "k11_then_k13", "fused") * 2:
        ms[turn] = min(ms[turn], min_ms(torch, builds[turn], 3,
                                        KERNEL_BATCH)[1])
        dev_ms[turn] = min(dev_ms[turn], graph_ms(torch, builds[turn], 3,
                                                  KERNEL_BATCH)[0])
    emit("kernel", check="the table build: the fused launch vs K11 then "
         "K13, in turns", inputs=inputs, ms=ms, device_ms=dev_ms)
    rows["code_tables"]["on_inputs"][inputs]["in_turns"] = {
        "ms": ms, "device_ms": dev_ms}


def as_tuple_tables(built) -> tuple:
    """(lengths, tables dict) -> (lengths, each table in layout order)."""
    lengths, tables = built
    return (lengths, *tables.values())


def k11_synthetic_rows():
    """(name, (rows, 256) int64 counts) of the rows that test K11's
    corners: the degenerate rows, ties, the 15-bit repair, int64 totals."""
    import numpy as np
    fib = np.zeros(256, np.int64)
    a, b = 1, 1
    for i in range(256):
        fib[i], (a, b) = a, (b, min(a + b, 1 << 50))
    one, two = np.zeros(256, np.int64), np.zeros(256, np.int64)
    one[42] = 999
    two[1], two[200] = 7, 1
    rng = np.random.default_rng(7)
    big = rng.integers(1 << 23, 1 << 24, 256).astype(np.int64)
    return [("all_zero", np.zeros((1, 256), np.int64)),
            ("one_symbol", one[None]), ("two_symbols", two[None]),
            ("all_256_equal", np.full((1, 256), 5, np.int64)),
            ("fibonacci_repair", np.stack([fib, rng.permutation(fib),
                                           np.where(np.arange(256) < 40,
                                                    fib, 0)])),
            ("total_over_2_31", np.stack([big, big << 8, big << 30])),
            ("random_256_rows", rng.integers(0, 10_000, (256, 256))
             * (rng.random((256, 256)) < rng.random((256, 1))))]


def phase_k11_synthetic(torch, dev) -> None:
    """K11 == its plain version == the host build on the corner rows, as
    int64 counts and, where the totals fit, as int32."""
    import numpy as np
    from mhc_tpu_torch.ops import huffman
    from mhc_tpu_torch.ops.kernels import huffman_cuda
    from mhc_tpu_torch.utils import native
    seen = {}
    for name, c in k11_synthetic_rows():
        dtypes = [torch.int64]
        if c.sum(axis=1).max() < 1 << 31:
            dtypes.append(torch.int32)
        host = native.code_lengths(huffman.rescale_counts(c),
                                   huffman.MAX_CODE_LEN)
        for dt in dtypes:
            t = torch.from_numpy(c).to(dev, dt)
            got = huffman_cuda.code_lengths(t)
            torch.cuda.synchronize()
            plain = huffman_cuda.code_lengths_plain(t)
            ok = (torch.equal(got, plain)
                  and bool((got.cpu().numpy() == host).all()))
            # the fused build: its rows, and row 0's over 256 rows
            for c_in, n in ((t, t.shape[0]), (t[:1], 256)):
                fused = as_tuple_tables(huffman_cuda.code_tables(c_in, n))
                ok = ok and all(torch.equal(a, b) for a, b in zip(
                    fused, as_tuple_tables(
                        huffman_cuda.code_tables_plain(c_in, n)),
                    strict=True))
            seen[f"{name}/{str(dt)[6:]}"] = ok
            if not ok:
                raise AssertionError(f"K11 or the fused build on {name} "
                                     f"({dt}) differs from its plain "
                                     "version or the host build")
    emit("kernel", check="code_lengths synthetic rows == plain == host; "
         "code_tables == its plain version",
         cases=seen, max_len=int(got.max()))


def expand_check(torch, rows: dict, payload, bounds, W: int,
                 inputs: str) -> None:
    """K9 (int32 words) or K12 (uint8 bytes) vs its plain version on a
    payload and its (R + 1,) host offsets; K9's library call, one
    torch.take over a prepared index (past a unit's length: a 0 entry
    appended to the payload), checked equal to K9. K12 has none."""
    import numpy as np
    from mhc_tpu_torch.ops import bitpack
    from mhc_tpu_torch.ops.kernels import stages_cuda
    dev = payload.device
    offs = torch.from_numpy(bounds).to(dev)
    library = None
    if payload.dtype == torch.int32:
        ext = torch.cat([payload, payload.new_zeros(1)])
        iw = torch.arange(W, device=dev)
        lens = torch.from_numpy(np.diff(bounds)).to(dev)
        idx = torch.where(iw[None, :] < lens[:, None],
                          offs[:-1, None] + iw[None, :], payload.numel())
        library = lambda: torch.take(ext, idx)
    (got,) = compare(
        torch, rows, "expand_units",
        lambda: stages_cuda.expand_units(payload, offs, W),
        lambda: bitpack.expand_units_plain(payload, offs, W), 10, 2, inputs,
        bound_bytes=lambda out: nbytes(payload, offs, *out), library=library,
        more={"layout": "bytes (K12)" if payload.dtype == torch.uint8
              else "words (K9)",
              **({} if library else {"library_ms_null_reason":
                                     "no one PyTorch call packs bytes at "
                                     "any offset into big-endian words"})})
    if library:
        same = torch.equal(library(), got)
        emit("kernel", check=f"torch.take(payload, index) == expand_units "
             f"({inputs})", equal=same)
        if not same:
            raise AssertionError("K9's library call differs from K9")


def stage_checks(torch, rows: dict, st, lengths, inputs: str) -> None:
    """K13, K10+K8, K9 (K12 too on order-0's parsed container) and K14
    against their plain versions on a path's inputs, tolerance 0: its
    tables, its units' K3 rows with the host's literal plan, the
    engine's payload, and K7's rows. K10+K8's library call, one
    torch.masked_select over the substituted plane and a prepared mask,
    checked equal to it; K13 and K14 have none. Beside K13, the floor of
    a launch on its grid (an empty kernel, timed the same ways)."""
    import numpy as np
    from mhc_tpu_torch import container, engine
    from mhc_tpu_torch.models.entropy import get_model
    from mhc_tpu_torch.ops import bitpack, canonical
    from mhc_tpu_torch.ops.kernels import (decode_cuda, encode_cuda,
                                           stages_cuda, tables_cuda)
    model = get_model(st.mode)
    dev = st.units.device
    L = torch.from_numpy(np.ascontiguousarray(lengths, np.uint8)
                         .reshape(-1, 256)).to(dev)
    # K13's floor: an empty kernel on its grid, timed as K13 is
    floor = lambda: tables_cuda.launch_floor(dev)
    t = compare(
        torch, rows, "canonical_tables",
        lambda: tuple(tables_cuda.canonical_tables(L, 256).values()),
        lambda: tuple(canonical.canonical_tables_plain(L, 256).values()),
        10, 3, inputs, bound_bytes=lambda out: nbytes(L, *out),
        more={"library_ms_null_reason": "no one PyTorch call builds "
              "canonical code tables",
              "launch_floor_ms": min_ms(torch, floor, 10, KERNEL_BATCH)[1],
              **device_fields(torch, floor, 10, KERNEL_BATCH,
                              "launch_floor_device_ms")})
    words, bits = encode_cuda.pack_units(st.units, st.n_valid, t[0], t[1])
    aligned = container.aligned_payload(model.mode)
    R, W = words.shape
    bits_h = bits.cpu().numpy().astype(np.int64)
    nv = engine.host_n_valid(st.orig_len, st.decode_unit, R)
    raw = bitpack.literal_unit_mask(bits_h, nv, aligned)
    wl = (np.where(raw, nv * 8, bits_h) + 31) // 32
    bounds = np.concatenate([[0], np.cumsum(wl)])
    offs, lit = engine.upload(dev, bounds, raw)
    args = (words, st.units, st.n_valid, offs, lit, int(bounds[-1]))
    sub = torch.where(lit.bool()[:, None],
                      bitpack.literal_words(st.units, st.n_valid, W), words)
    mask = (torch.arange(W, device=dev)[None, :]
            < torch.from_numpy(wl).to(dev)[:, None])
    read = 4 * int(wl[~raw].sum()) + int(nv[raw].sum())
    (payload,) = compare(
        torch, rows, "compact_units",
        lambda: stages_cuda.compact_units(*args),
        lambda: bitpack.compact_units_plain(*args), 10, 2, inputs,
        bound_bytes=lambda out: read + nbytes(st.n_valid, offs, lit, *out),
        library=lambda: torch.masked_select(sub, mask),
        more={"literal_units": int(raw.sum())})
    same = torch.equal(torch.masked_select(sub, mask), payload)
    emit("kernel", check="torch.masked_select(substituted plane, mask) == "
         f"compact_units ({inputs})", equal=same)
    if not same:
        raise AssertionError("K10+K8's library call differs from K10+K8")
    del sub, mask, words, args
    enc = engine.encode(st, lengths=lengths)
    if not torch.equal(enc.payload, payload):
        raise AssertionError(f"{inputs}: engine.encode's payload is not "
                             "compact_units'")
    w, n_dec, raw, td, lit_rows = engine._decode_inputs(enc)
    expand_check(torch, rows, enc.payload,
                 np.concatenate([[0], np.cumsum((enc.bit_lens + 31) // 32)]),
                 w.shape[1], inputs)
    if not enc.aligned:
        meta = container.parse_container(engine.assemble_container(enc,
                                                                   None))
        lens = meta.byte_lengths.astype(np.int64)
        parsed = torch.from_numpy(np.frombuffer(
            engine.fetch_payload(enc), np.uint8).copy()).to(dev)
        expand_check(torch, rows, parsed,
                     np.concatenate([[0], np.cumsum(lens)]),
                     int(-(-lens.max() // 4)) + 1, f"{inputs}_parsed")
        del parsed
    du = enc.decode_unit
    out = decode_cuda.decode_units(
        w, n_dec, td["lim"], td["base"], td["first_code"],
        td["sorted_syms"], n_out=du, markov=model.markov)
    n_lit = lit_rows.numel()
    moved = n_lit * (min(w.shape[1], du // 4) * 4 + du)
    kern_out, plain_out = out.clone(), out.clone()
    compare(torch, rows, "literal_rows",
            lambda: stages_cuda.literal_rows(kern_out, w, lit_rows),
            lambda: bitpack.literal_rows_plain(plain_out, w, lit_rows),
            10, 2, inputs,
            bound_bytes=lambda o: moved + nbytes(lit_rows),
            more={"literal_rows": n_lit, "library_ms_null_reason":
                  "no one PyTorch call writes big-endian word bytes into "
                  "chosen rows"})


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
    k11_checks(torch, rows, MARKOV, counts, "markov")
    code_tables_checks(torch, rows, counts, "markov")
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
    stage_checks(torch, rows, st, lengths, "markov")
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
    cl_packers_checks(torch, rows, cl, fused, "payload_route", payload=True)


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
    k11_checks(torch, rows, ORDER0, counts, "order0")
    code_tables_checks(torch, rows, counts, "order0")
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
    stage_checks(torch, rows, st, lengths, "order0")
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
    """want: kernel -> "once" (exactly 1), "some" (>= 1), "none" (0) or
    an exact count."""
    ok = {"once": lambda n: n == 1, "some": lambda n: n >= 1,
          "none": lambda n: n == 0}
    bad = {k: launches[k] for k, rule in want.items()
           if not (launches[k] == rule if isinstance(rule, int)
                   else ok[rule](launches[k]))}
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


def host_build_encode(st):
    """engine.encode of `st` with the host table build, as the port runs
    it off a card: the counts fetched, the native builder, the lengths
    passed in."""
    from mhc_tpu_torch import engine
    from mhc_tpu_torch.models.entropy import get_model
    return engine.encode(st, lengths=get_model(st.mode).lengths_from_counts(
        engine.histogram(st)))


def table_build_turns(torch, st, turns: int = 2) -> dict:
    """engine.encode of `st` (the fused table build on the card) and
    `host_build_encode` in turns (device, host, host, device, `turns`
    times): the minimum ms of each, CUDA events around each call (the
    call ends in a sync)."""
    from mhc_tpu_torch import engine
    return in_turns(torch, {"device": lambda: engine.encode(st),
                            "host": lambda: host_build_encode(st)}, turns)


def host_route(torch, st, path: str, crc: int, ref_len: int,
               ref_sha: str) -> dict:
    """`host_build_encode`, counted: K11 and the fused build never
    launched, K13 once on the given lengths; the reference container.
    Returns its launches."""
    from mhc_tpu_torch import engine
    enc, launches = run_counted(torch, lambda: host_build_encode(st))
    require_launches(f"{path} (host build)", launches,
                     {"code_lengths": "none", "code_tables": "none",
                      "canonical_tables": "once"})
    check_container(f"{path} (host build)",
                    engine.assemble_container(enc, crc), ref_len, ref_sha)
    return launches


def round_trip(torch, data: bytes, mode: str, dev, path: str,
               want: dict, ref_len: int, ref_sha: str):
    """One path end to end through the engine with the device table
    build, counted; the host build's encode counted too; both timed in
    turns. Returns (container, launches)."""
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
    crc = zlib.crc32(data) & 0xFFFFFFFF
    host_launches = host_route(torch, st, path, crc, ref_len, ref_sha)
    enc_ms = table_build_turns(torch, st)
    _, dec_ms = min_ms(torch, lambda: engine.decode(enc), TIMED_REPS)
    peak = torch.cuda.max_memory_allocated()

    blob = engine.assemble_container(enc, crc)
    raw = int(bitpack.raw_unit_mask(enc.byte_lens, st.n_valid.cpu().numpy(),
                                    enc.aligned).sum())
    emit(path, mode=mode, n_bytes=len(data), n_units=enc.n_units,
         decode_unit=enc.decode_unit, literal_units=raw, launches=launches,
         host_build_launches=host_launches,
         host_table_builder="native C++" if native.available() else "numpy",
         encode_ms=enc_ms["device"], encode_ms_host_build=enc_ms["host"],
         decode_ms=dec_ms, encode_GBps=len(data) / enc_ms["device"] / 1e6,
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


def device_idle_share(torch, fn):
    """1 - (device busy time) / (host wall time) over one call of fn(),
    the busy time the union of the CUDA intervals torch.profiler traced;
    None when it traced no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return 1 - busy / wall_us if spans else None


def phase_breakdown(torch, data: bytes, dev) -> None:
    """The engine's stages at 100 MB, both modes, the device table build:
    each stage as `engine.encode` / `engine.decode` run it, on the host
    clock between synchronisations, minimum of 4; the table builds side
    by side (the fused device build the encode runs; K11 alone; the host
    build with the counts fetched, alone and followed by K13; K13 alone);
    the whole encode with each table build beside them; and the device's
    idle share over one encode + decode (torch.profiler). Returns the
    launches of one `lengths_for` call (K11 alone, the build of the
    callers that need only lengths), counted on the Markov counts."""
    from mhc_tpu_torch import container, engine
    from mhc_tpu_torch.models.entropy import get_model
    from mhc_tpu_torch.ops.kernels import (decode_cuda, encode_cuda,
                                           stages_cuda)
    lengths_only = None
    for mode in ("markov", "huffman"):
        torch.cuda.empty_cache()
        model = get_model(mode)
        st = engine.stage(data, mode=mode, device=dev)
        u, nv = st.units, st.n_valid
        aligned = container.aligned_payload(model.mode)
        ms: dict = {}

        def stage(name, fn):
            out, secs = wall_s(torch, fn)
            ms[name] = min(ms.get(name, float("inf")), secs * 1e3)
            return out

        for _ in range(4):
            counts = stage("histogram", lambda: model.histogram(u, nv))
            stage("device_table_build",
                  lambda: model.tables_for(counts, dev))
            lengths = stage("k11_table_build",
                            lambda: model.lengths_for(counts))
            stage("host_table_build_with_counts_d2h",
                  lambda: model.lengths_from_counts(counts.cpu().numpy()))
            stage("host_table_build_plus_canonical_tables",
                  lambda: model.tables_from_lengths(model.lengths_from_counts(
                      counts.cpu().numpy()), dev))
            t = stage("canonical_tables",
                      lambda: model.tables_from_lengths(lengths, dev))
            words, bits = stage("k3_pack", lambda: encode_cuda.pack_units(
                u, nv, t["codes"], t["lengths"]))
            # the bits fetch, the literal plan and K10+K8, one stage:
            # literal substitution and compaction are one kernel
            stage("bits_fetch_literals_and_compaction",
                  lambda: engine.compact(st, words, bits, aligned))
            enc = stage("encode_total", lambda: engine.encode(st))
            stage("encode_total_host_build", lambda: host_build_encode(st))
            w, n_dec, raw, td, lit = stage(
                "decode_inputs", lambda: engine._decode_inputs(enc))
            out = stage("k7_with_table_build",
                        lambda: decode_cuda.decode_units(
                            w, n_dec, td["lim"], td["base"], td["first_code"],
                            td["sorted_syms"], n_out=enc.decode_unit,
                            markov=model.markov))
            stage("literal_rows",
                  lambda: stages_cuda.literal_rows(out, w, lit))
            stage("decode_total", lambda: engine.decode(enc))
        if mode == "markov":
            _, lengths_only = run_counted(torch,
                                          lambda: model.lengths_for(counts))
            require_launches("lengths_for", lengths_only,
                             {"code_lengths": "once", "code_tables": "none",
                              "canonical_tables": "none"})
        idle = device_idle_share(
            torch, lambda: engine.decode(engine.encode(st)))
        emit("breakdown", mode=mode, n_bytes=len(data), stage_ms=ms,
             device_idle_share_enc_dec=idle,
             **({"lengths_for_launches": lengths_only}
                if mode == "markov" else {}))
    return lengths_only


def in_turns(torch, fns: dict, turns: int = 4) -> dict:
    """{name: minimum ms} of two calls timed in turns (a, b, b, a,
    `turns` times), CUDA events around each call (each ends in a sync)."""
    a, b = fns
    ms = {a: float("inf"), b: float("inf")}
    for turn in (a, b, b, a) * turns:
        ms[turn] = min(ms[turn], min_ms(torch, fns[turn], 1)[1])
    return ms


def phase_redesign_turns(torch, data: bytes, dev) -> None:
    """This slice's redesigns against the designs they replace, in turns
    in this process: the encode with the fused table build against the
    encode with K11's lengths passed in, whose tables K13 then builds
    (the two launches the fused one replaces), both modes; and the
    "pallas" encodes (rows; the payload route) with K15 against the same
    encodes with the plain compactions in its place."""
    from mhc_tpu_torch import engine
    from mhc_tpu_torch.models.entropy import get_model
    from mhc_tpu_torch.ops import bitpack
    from mhc_tpu_torch.ops.kernels import stages_cuda
    out = {}
    for mode in ("markov", "huffman"):
        torch.cuda.empty_cache()
        st = engine.stage(data, mode=mode, device=dev)
        model = get_model(mode)
        k11 = lambda: model.lengths_for(model.histogram(st.units,
                                                        st.n_valid))
        out[f"{mode}_encode"] = in_turns(torch, {
            "fused_table_build": lambda: engine.encode(st),
            "k11_then_k13": lambda: engine.encode(st, lengths=k11())})
        del st
    k15 = (stages_cuda.compact_bubbles, stages_cuda.bubbles_to_payload)

    def plain_compactions(st):
        stages_cuda.compact_bubbles = bitpack.compact_bubbles
        stages_cuda.bubbles_to_payload = bitpack.bubbles_to_payload
        try:
            return engine.encode(st, pack_method="pallas")
        finally:
            stages_cuda.compact_bubbles, stages_cuda.bubbles_to_payload = k15

    for route, du in (("markov_pallas_encode", None),
                      ("payload_route_encode", 65536)):
        torch.cuda.empty_cache()
        st = engine.stage(data, decode_unit=du, device=dev)
        out[route] = in_turns(torch, {
            "k15": lambda: engine.encode(st, pack_method="pallas"),
            "plain_compaction": lambda: plain_compactions(st)})
        del st
    emit("redesign_turns", n_bytes=len(data), encode_ms=out)


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
    ms = in_turns(torch, {
        "fused": lambda: engine.encode(st),
        pack_method: lambda: engine.encode(st, pack_method=pack_method)}, 2)
    blob = engine.assemble_container(enc, zlib.crc32(data) & 0xFFFFFFFF)
    emit(path, n_bytes=len(data), launches=launches,
         encode_ms=ms[pack_method],
         encode_GBps=len(data) / ms[pack_method] / 1e6,
         fused_encode_ms_in_turns=ms["fused"], container_bytes=len(blob),
         sha256=hashlib.sha256(blob).hexdigest())
    check_container(path, blob, REF_100MB_LEN, REF_100MB_SHA256)
    return launches


def phase_payload_route(torch, data: bytes, dev):
    """Markov 100 MB with decode_unit == block_size through
    pack_method="pallas": K6's bubble stream straight to the payload
    (K15). Returns (the container, its launches)."""
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
                      "decode_lut": "once", "decode_units": "once",
                      # no literal units, and the bubble stream goes
                      # straight to the payload (K15): no rows, no
                      # K10+K8, no K14
                      **DEVICE_BUILD, "canonical_tables": "once",
                      "bubbles_to_payload": "once",
                      "compact_bubbles": "none", "compact_units": "none",
                      "expand_units": "once", "literal_rows": "none"})
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
    return blob, launches


def phase_order0_pallas(torch, data: bytes, dev) -> None:
    """Order-0 100 MB through api.compress(pack_method="pallas")."""
    from mhc_tpu_torch import api
    torch.cuda.empty_cache()
    blob, launches = run_counted(torch, lambda: api.compress(
        data, mode="huffman", device=dev, pack_method="pallas"))
    require_launches("order0_pallas", launches,
                     {"order0_hist": "some", "lookup_cl": "some",
                      "bubble_pack": "some", "pack_units": "none",
                      "markov_hist": "none", **DEVICE_BUILD,
                      "canonical_tables": "none", "compact_bubbles": "some",
                      "bubbles_to_payload": "none",
                      "compact_units": "some"})
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
    n_chunks = len(api._chunks(0, -(-len(data) // api.DEFAULT_DECODE_UNIT),
                               api.DEFAULT_DECODE_UNIT))
    if n_chunks < 2:
        raise AssertionError("host_bytes: the default chunk size gives "
                             f"{n_chunks} chunk at 100 MB")
    blob, launches = run_counted(
        torch, lambda: api.compress(data, device=dev))
    require_launches("host_bytes", launches,
                     {"markov_hist": "some", **DEVICE_BUILD,
                      "pack_units": "some", "canonical_tables": "none",
                      "compact_units": "some"})
    check_container("host_bytes", blob, REF_100MB_LEN, REF_100MB_SHA256)
    out, dec_launches = run_counted(
        torch, lambda: api.decompress(blob, device=dev))
    if out != data:
        raise AssertionError("host_bytes: api.decompress did not return "
                             "the input")
    require_launches("host_bytes decompress", dec_launches,
                     {"decode_units": "some", **STAGES_DECODE})
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


def phase_small(torch, dev) -> None:
    """1 MB, one block (BASELINE configs 1-2), both modes: the device and
    the host table build each counted and writing the reference
    container, then timed in turns through engine.encode (CUDA events);
    api.compress timed too (host wall clock, host bytes in and out)."""
    from mhc_tpu_torch import api, engine
    from mhc_tpu_torch.utils.corpus import make_corpus
    data = make_corpus(1 << 20)
    crc = zlib.crc32(data) & 0xFFFFFFFF
    for mode, ref_len, ref_sha in (
            ("markov", REF_1MB_LEN, REF_1MB_SHA256),
            ("huffman", REF_ORDER0_1MB_LEN, REF_ORDER0_1MB_SHA256)):
        path = f"small_{mode}"
        st = engine.stage(data, mode=mode, block_size=1 << 20, device=dev)
        enc, launches = run_counted(torch, lambda: engine.encode(st))
        require_launches(path, launches, STAGES_ENCODE)
        check_container(path, engine.assemble_container(enc, crc),
                        ref_len, ref_sha)
        host_launches = host_route(torch, st, path, crc, ref_len, ref_sha)
        enc_ms = table_build_turns(torch, st, turns=3)
        api_s = float("inf")
        for _ in range(6):
            blob, t = wall_s(torch, lambda: api.compress(
                data, mode=mode, block_size=1 << 20, device=dev))
            check_container(f"{path} api.compress", blob, ref_len, ref_sha)
            api_s = min(api_s, t)
        emit("small", mode=mode, n_bytes=len(data), block_size=1 << 20,
             n_units=enc.n_units, launches=launches,
             host_build_launches=host_launches, encode_ms=enc_ms,
             compress_s=api_s, container_bytes=ref_len, sha256=ref_sha)


def phase_param_grid(torch, dev) -> None:
    """The parameter grid on the card (see the module docstring): any
    container or decode that differs from the table or the input
    raises."""
    import collections
    from mhc_tpu_torch import api, engine, hybrid
    from mhc_tpu_torch.ops.kernels import _build
    from mhc_tpu_torch.parallel import pipeline
    from mhc_tpu_torch.utils import corpus
    table = corpus.load_grid_table()
    inputs = corpus.grid_inputs()
    src, dst, back = (os.path.join(_build.BUILD_DIR, f"param_grid.{n}")
                      for n in ("in", "mhc", "back"))
    cases: collections.Counter = collections.Counter()

    def check(route: str, key: str, blob: bytes, want: list) -> None:
        got = [len(blob), hashlib.sha256(blob).hexdigest()]
        if got != want:
            raise AssertionError(f"param_grid {route} {key}: container "
                                 f"{got} differs from the reference's "
                                 f"{want}")
        cases[route] += 1

    def decoded(route: str, key: str, out: bytes, x: bytes) -> None:
        if out != x:
            raise AssertionError(f"param_grid {route} {key}: the decode "
                                 "is not the input")
        cases[route] += 1

    def routes(key: str, x: bytes, want: list, kw: dict) -> None:
        blob = hybrid.compress(x, host_fraction=0.5, device=dev, **kw)
        check("hybrid.compress", key, blob, want)
        decoded("hybrid.decompress", key, hybrid.decompress(
            blob, host_fraction=0.5, device=dev), x)
        check("compress_sharded", key,
              pipeline.compress_sharded(x, device=dev, **kw), want)
        decoded("decompress_sharded", key,
                pipeline.decompress_sharded(blob, device=dev), x)
        with open(src, "wb") as f:
            f.write(x)
        api.compress_file(src, dst, segment_size=corpus.GRID_SEGMENT,
                          device=dev, **kw)
        with open(dst, "rb") as f:
            check("compress_file", key, f.read(),
                  table["files"][key] if len(x) > corpus.GRID_SEGMENT
                  else want)
        api.decompress_file(dst, back, device=dev)
        with open(back, "rb") as f:
            decoded("decompress_file", key, f.read(), x)

    def grid() -> None:
        for mode in corpus.GRID_MODES:
            for bs in corpus.GRID_BLOCK_SIZES:
                for name, x in inputs.items():
                    for arg, du, crc in corpus.grid_cases(mode, bs):
                        key = corpus.grid_key(name, mode, bs, du, crc)
                        want = table["containers"][key]
                        kw = dict(mode=mode, block_size=bs,
                                  decode_unit=arg, crc=crc)
                        for pm in engine.PACK_METHODS:
                            blob = api.compress(x, device=dev,
                                                pack_method=pm, **kw)
                            check(f"api.compress/{pm}", key, blob, want)
                        decoded("api.decompress", key,
                                api.decompress(blob, device=dev), x)
                        if bs in corpus.GRID_ROUTE_BLOCK_SIZES:
                            routes(key, x, want, kw)

    torch.cuda.empty_cache()
    (_, seconds), launches = run_counted(torch, lambda: wall_s(torch, grid))
    # every codec and stage kernel ran on the grid's widths; K11 alone
    # runs only on `lengths_for`
    require_launches("param_grid", launches, {
        k: "none" if k == "code_lengths" else "some"
        for k in KERNELS if "/" not in k})
    per_route = dict(cases)
    for p in (src, dst, back):
        os.remove(p)
    # the corpus at block_size 1: 300,001 units, a block per unit in
    # K10+K8, K9 and K15
    x = inputs["corpus"]
    unit_1 = {}
    for mode in corpus.GRID_MODES:
        want = table["containers"][corpus.grid_key("corpus", mode, 1, 1,
                                                   True)]
        for pm in engine.PACK_METHODS:
            blob, t = wall_s(torch, lambda: api.compress(
                x, mode=mode, block_size=1, device=dev, pack_method=pm))
            check(f"api.compress/{pm}", f"corpus {mode} bs=1 (timed)",
                  blob, want)
            unit_1[f"{mode}/compress/{pm}_s"] = t
        out, t = wall_s(torch, lambda: api.decompress(blob, device=dev))
        decoded("api.decompress", f"corpus {mode} bs=1 (timed)", out, x)
        unit_1[f"{mode}/decompress_s"] = t
    emit("param_grid", n_cases=sum(
        len(corpus.grid_cases(m, bs)) * len(inputs)
        for m in corpus.GRID_MODES for bs in corpus.GRID_BLOCK_SIZES),
        cases_per_route=per_route, launches={
            k: n for k, n in launches.items() if n}, seconds=seconds,
        corpus_block_size_1=dict(n_bytes=len(x), n_units=len(x),
                                 **unit_1))


def sharded_worker(argv) -> None:
    """One rank of the `sharded` phase (`chip_smoke.py --sharded-rank
    RANK WORLD BACKEND STORE CORPUS OUT_DIR MODES`): compress_sharded and
    decompress_sharded of the corpus on cuda:0, twice per mode, each
    timed on the host clock; the results in OUT_DIR/rank<RANK>.json."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from mhc_tpu_torch.ops.kernels import _build
    from mhc_tpu_torch.parallel import mesh as meshmod, pipeline
    rank, world, backend, store, corpus, out_dir, modes = argv
    rank, world = int(rank), int(world)
    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = meshmod.make_mesh("cuda:0")
        with open(corpus, "rb") as f:
            data = f.read()
        res = {"rank": rank, "backend": dist.get_backend(),
               "device": str(mesh.device),
               "comm_device": str(mesh.comm_device)}
        for mode in modes.split(","):
            times = {"compress_s": [], "decompress_s": []}
            for _ in range(2):
                dist.barrier()
                torch.cuda.synchronize()
                _build.LAUNCHES.clear()
                t0 = time.perf_counter()
                blob = pipeline.compress_sharded(data, mesh, mode=mode)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                back = pipeline.decompress_sharded(blob, mesh)
                torch.cuda.synchronize()
                times["compress_s"].append(t1 - t0)
                times["decompress_s"].append(time.perf_counter() - t1)
            res[mode] = {**times, "container_bytes": len(blob),
                         "sha256": hashlib.sha256(blob).hexdigest(),
                         "round_trip": back == data,
                         "launches": dict(_build.LAUNCHES)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_sharded(torch, corpus_path: str) -> None:
    """The sharded pipeline on the one card, each rank a subprocess
    meeting the others through a FileStore: (a) one NCCL rank, Markov;
    (b) two gloo ranks sharing cuda:0, Markov and order-0. Every rank's
    container must be the reference's and round-trip; wall seconds of
    each leg. Scaling needs more cards than the machine has."""
    import shutil
    from mhc_tpu_torch.ops.kernels import _build
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    refs = {"markov": REF_100MB_SHA256, "huffman": REF_ORDER0_100MB_SHA256}
    env = dict(os.environ, PYTHONPATH=REPO)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    legs = {}
    for leg, backend, world, modes in SHARDED_LEGS:
        tmp = os.path.join(_build.BUILD_DIR, f"sharded_{leg}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        procs = []
        t0 = time.perf_counter()
        try:
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.log"), "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__),
                         "--sharded-rank", str(r), str(world), backend,
                         os.path.join(tmp, "store"), corpus_path, tmp,
                         modes], cwd=REPO, env=env, stdout=log,
                        stderr=subprocess.STDOUT))
            codes = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        if any(codes):
            bad = next(r for r, c in enumerate(codes) if c)
            with open(os.path.join(tmp, f"rank{bad}.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"sharded {leg}: rank exit codes {codes}:"
                                 f"\n{tail}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for res in ranks:
            for mode in modes.split(","):
                got = res[mode]
                if got["sha256"] != refs[mode] or not got["round_trip"]:
                    raise AssertionError(
                        f"sharded {leg} rank {res['rank']} {mode}: "
                        f"container {got['sha256']} (reference "
                        f"{refs[mode]}), round trip {got['round_trip']}")
                require_launches(
                    f"sharded {leg} rank {res['rank']} {mode}",
                    {k: got["launches"].get(k, 0) for k in KERNELS},
                    {**STAGES_DECODE, "code_tables": "some",
                     "code_lengths": "none", "compact_units": "some"})
        legs[leg] = {"backend": backend, "ranks": world,
                     "wall_s_all_processes": wall, "per_rank": ranks}
    emit("sharded", n_bytes=CORPUS_BYTES, legs=legs,
         scaling="unmeasured (1 card)")


def phase_cli(torch, corpus_path: str, data: bytes) -> None:
    """The file functions the CLI calls, in this process and counted
    (api.compress_file / decompress_file at 32 MB segments: the stage
    kernels launched), then the CLI as a user runs it, in
    subprocesses."""
    from mhc_tpu_torch import api
    out_dir = os.path.dirname(corpus_path)
    mhc = os.path.join(out_dir, "corpus_seg32m.mhc")
    back = os.path.join(out_dir, "corpus_back.bin")
    _, file_enc = run_counted(torch, lambda: api.compress_file(
        corpus_path, mhc, segment_size=32 << 20, device="cuda:0"))
    with open(mhc, "rb") as f:
        check_container("files", f.read(), REF_100MB_SEG32M_LEN,
                        REF_100MB_SEG32M_SHA256)
    require_launches("files compress", file_enc,
                     {"code_tables": "some", "code_lengths": "none",
                      "canonical_tables": "none", "compact_units": "some"})
    _, file_dec = run_counted(torch, lambda: api.decompress_file(
        mhc, back, device="cuda:0"))
    with open(back, "rb") as f:
        if f.read() != data:
            raise AssertionError("files: decompress_file did not return "
                                 "the input")
    require_launches("files decompress", file_dec, STAGES_DECODE)
    for p in (mhc, back):
        os.remove(p)

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
         container_bytes=len(blob), sha256=hashlib.sha256(blob).hexdigest(),
         file_launches={"compress": file_enc, "decompress": file_dec})
    for p in (mhc, back):
        os.remove(p)


def phase_hybrid(torch, data: bytes, dev) -> None:
    """hybrid.compress / decompress at host_fraction 0.5, counted: the
    device's share through the engine's stage kernels."""
    from mhc_tpu_torch import hybrid
    torch.cuda.empty_cache()
    (blob, c), enc_launches = run_counted(torch, lambda: wall_s(
        torch, lambda: hybrid.compress(data, host_fraction=0.5,
                                       device=dev)))
    check_container("hybrid", blob, REF_100MB_LEN, REF_100MB_SHA256)
    require_launches("hybrid compress", enc_launches,
                     {"canonical_tables": "once", "compact_units": "once"})
    (out, d), dec_launches = run_counted(torch, lambda: wall_s(
        torch, lambda: hybrid.decompress(blob, host_fraction=0.5,
                                         device=dev)))
    if out != data:
        raise AssertionError("hybrid: decompress did not return the input")
    require_launches("hybrid decompress", dec_launches, STAGES_DECODE)
    emit("hybrid", n_bytes=len(data), host_fraction=0.5, compress_s=c,
         decompress_s=d, container_bytes=len(blob),
         launches={"compress": enc_launches, "decompress": dec_launches})


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


# Crafted containers whose header, tables and index would drive a decoder
# past what the encoder can write (tests/test_torch_corrupt.py sends them
# through every route on the CPU, phase_corrupt through api.decompress on
# the card): each must raise ValueError, never abort the process nor size
# an allocation by the claim.
CRAFT_PREFIX = 300_001   # of make_corpus(1 << 19)
CRAFT_UNIT = 4096


def craft_source(mode: str) -> bytes:
    """The clean container the crafted ones start from: the first
    300,001 bytes of make_corpus(1 << 19) in `mode`, 64 KB blocks,
    4 KB decode units, crc on, compressed on the CPU."""
    from mhc_tpu_torch import api
    from mhc_tpu_torch.utils.corpus import make_corpus
    data = make_corpus(1 << 19)[:CRAFT_PREFIX]
    return api.compress(data, mode=mode, block_size=1 << 16,
                        decode_unit=CRAFT_UNIT, device="cpu")


def overfull_code_lengths(blob: bytes) -> bytes:
    """Every code length of the first table read set to 1, a Kraft sum of
    8 (16 nibble lengths) or of 128 (256): the 16 nibble code lengths of
    a Markov container's packed table section (bytes 56-63, after the
    header and the 32-byte context bitmap), or the 128-byte order-0
    table (bytes 24-151)."""
    from mhc_tpu_torch import container
    meta = container.parse_container(blob)
    if meta.mode == container.MODE_MARKOV:
        if not meta.flags & container.FLAG_PACKED_TABLES:
            raise AssertionError("overfull_code_lengths: tables not packed")
        start, end = 56, 64
    else:
        start, end = 24, 152
    return blob[:start] + b"\x11" * (end - start) + blob[end:]


def packed_index64(values) -> bytes:
    """A plain packed unit index (base 0) of 64-bit residuals: each value
    as its two's complement bits, so a reader summing bit << i in int64
    reads it back, negative ones included."""
    import struct
    import numpy as np
    v = np.asarray(values, np.int64).view(np.uint64)
    bits = ((v[:, None] >> np.arange(64, dtype=np.uint64))
            & np.uint64(1)).astype(np.uint8)
    return (struct.pack("<HB", 0, 64)
            + np.packbits(bits.reshape(-1), bitorder="little").tobytes())


def with_index(blob: bytes, index: bytes, payload: bytes | None = None,
               orig_len: int | None = None) -> bytes:
    """A substream container with its unit index replaced by `index` (a
    plain packed index), and optionally its payload (the crc trailer
    kept) and `orig_len`."""
    import struct
    from mhc_tpu_torch import container
    meta = container.parse_container(blob)
    start = meta.payload_off - meta.index_bytes
    head = bytearray(blob[:start])
    head[6] = ((meta.flags | container.FLAG_PACKED_INDEX)
               & ~(container.FLAG_ENTROPY_INDEX
                   | container.FLAG_GROUPED_INDEX))
    if orig_len is not None:
        struct.pack_into("<Q", head, 8, orig_len)
    if payload is None:
        payload = blob[meta.payload_off:container.container_size(meta) - 4]
    return bytes(head) + index + payload + blob[-4:]


def negative_unit_length(blob: bytes) -> bytes:
    """An aligned (Markov) container whose unit 0 reads -100 bytes and
    unit 1 100 more than units 0 and 1 held together: the payload's size,
    and so the parse, would stay as they were."""
    from mhc_tpu_torch import container
    meta = container.parse_container(blob)
    words = meta.byte_lengths // 4
    words[1] += words[0] + 25
    words[0] = -25
    return with_index(blob, packed_index64(words))


def orig_len_claim(blob: bytes) -> bytes:
    """Header and tables of `blob` with orig_len 2**27 (32,768 units of
    4 KB), an index of base 0 and no residual bits, no payload, the crc
    trailer: a decoder that sized its output by orig_len alone would
    decode 128 MB."""
    import struct
    return with_index(blob, struct.pack("<HB", 0, 0), payload=b"",
                      orig_len=1 << 27)


def short_units(blob: bytes) -> bytes:
    """orig_len_claim with a payload: every unit one word (4 bytes), under
    the 512 bytes the fewest bits of a 4 KB unit take."""
    import struct
    return with_index(blob, struct.pack("<HB", 1, 0),
                      payload=bytes(4 * ((1 << 27) // CRAFT_UNIT)),
                      orig_len=1 << 27)


def payload_size_overflow(blob: bytes) -> bytes:
    """An aligned (Markov) container whose units 0 and 1 claim 2**60 words
    each: 2**62 bytes each, a payload size past 2**63 that reads negative
    in int64."""
    from mhc_tpu_torch import container
    words = container.parse_container(blob).byte_lengths // 4
    words[:2] = 1 << 60
    return with_index(blob, packed_index64(words))


# F5's containers (ROADMAP.md section 3): a header field that sized the
# decode with no bound. The base is F5_TEXT in 4 KB blocks, in 1 KB decode
# units (the substream layout) or in one 4 KB unit (the legacy layout).
F5_TEXT = b"hello world, hello markov " * 20


def f5_source(legacy: bool) -> bytes:
    from mhc_tpu_torch import api
    return api.compress(F5_TEXT, block_size=4096,
                        decode_unit=4096 if legacy else 1024, device="cpu")


def with_field(blob: bytes, offset: int, fmt: str, value: int) -> bytes:
    """`blob` with the header field at `offset` rewritten to `value`."""
    import struct
    out = bytearray(blob)
    struct.pack_into(fmt, out, offset, value)
    return bytes(out)


def f5_containers() -> dict:
    """name -> (container, what its ValueError must say, or None where it
    decodes to F5_TEXT): (a) the substream container's du_log2 (byte 7)
    rewritten to 40, 63, 64 or 200; (b) the legacy container's block size
    (bytes 16-19) rewritten to 0; (d) to 2**31 or 2**32 - 1, where the one
    short block decodes in rows of its own length."""
    sub, leg = f5_source(False), f5_source(True)
    cases = {f"du_log2_{v}": (with_field(sub, 7, "<B", v), "decode unit")
             for v in (40, 63, 64, 200)}
    cases["block_size_0"] = (with_field(leg, 16, "<I", 0), "block size")
    for v in (1 << 31, (1 << 32) - 1):
        cases[f"legacy_block_size_{v}"] = (with_field(leg, 16, "<I", v), None)
    return cases


def crafted_containers() -> dict:
    """name -> (crafted container, what its ValueError must say)."""
    markov, order0 = craft_source("markov"), craft_source("huffman")
    return {"overfull_code_lengths_markov": (
                overfull_code_lengths(markov), "code lengths"),
            "overfull_code_lengths_order0": (
                overfull_code_lengths(order0), "code lengths"),
            "negative_unit_length": (negative_unit_length(markov),
                                     "unit length"),
            "orig_len_claim": (orig_len_claim(markov), "truncated"),
            "short_units": (short_units(markov), "unit length"),
            "payload_size_overflow": (payload_size_overflow(markov),
                                      "payload size")}


def phase_corrupt(torch, blob: bytes, data: bytes, du64k_blob: bytes,
                  dev) -> None:
    """Damaged containers decoded on the card raise ValueError, with no
    CUDA error, and the card decodes cleanly afterwards. The payload
    route's container whose unit 0 claims the whole payload (1,600 rows
    of 20.9 M words, were its length believed) raises before anything is
    allocated for it; so do the crafted containers (over-full code
    lengths, a negative unit length, an orig_len the index cannot hold,
    units shorter than their symbols, a payload size past 2**63); F5's
    cases run in `f5_cases`."""
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
    for name, (bad, want) in crafted_containers().items():
        try:
            api.decompress(bad, device=dev)
        except ValueError as e:
            if want not in str(e):
                raise AssertionError(f"corrupt {name}: {e}") from e
            seen[name] = str(e)
        else:
            raise AssertionError(f"corrupt {name}: decoded without error")
    t0 = time.perf_counter()
    f5 = f5_cases(torch, dev)
    f5["f5_wall_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    if api.decompress(blob, device=dev) != data:
        raise AssertionError("corrupt: the clean decode afterwards failed")
    emit("corrupt", errors=seen, clean_decode_after=True,
         unit_claims_payload_max_memory_allocated={"before": before,
                                                   "after": after}, **f5)


def f5_cases(torch, dev) -> dict:
    """F5 on the card (ROADMAP.md section 3): each of f5_containers()
    through api.decompress and hybrid.decompress (0.5) is refused with
    ValueError before any launch, with at most 1 MiB of peak allocation
    over the case's start, or (a legacy block size of 2**31 or 2**32 - 1)
    decodes to F5_TEXT with K7 at n_out engine.row_width (528: the
    520-byte block rounded up to 16), with at most 1 MiB more peak
    allocation than the same route's decode of the clean legacy container
    (whose own decode tables take ~1.1 MB: Markov's K13 table set,
    835,584 B, and K7's table, 203,776 B); no CUDA error; and api.compress
    and hybrid.compress refuse block sizes of 0 and 2**32 before any
    kernel launch and allocation."""
    from mhc_tpu_torch import api, hybrid
    from mhc_tpu_torch.ops.kernels import decode_cuda
    real_decode = decode_cuda.decode_units
    widths = []

    def spy(*args, n_out, **kwargs):
        widths.append(n_out)
        return real_decode(*args, n_out=n_out, **kwargs)

    def measured(name, fn, limit=None):
        """(fn's bytes or its ValueError's text, {kernel: launches}, peak
        bytes over the start), the case failed past `limit` bytes."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.max_memory_allocated()

        def run():
            try:
                return fn()
            except ValueError as e:
                return str(e)
        out, launches = run_counted(torch, run)
        over = torch.cuda.max_memory_allocated() - before
        if limit is not None and over > limit:
            raise AssertionError(f"corrupt {name}: {over} bytes allocated")
        return out, {k: n for k, n in launches.items() if n}, over

    routes = {"api": lambda b: api.decompress(b, device=dev),
              "hybrid": lambda b: hybrid.decompress(b, host_fraction=0.5,
                                                    device=dev)}
    clean = f5_source(True)
    clean_peak = {}
    for route, fn in routes.items():
        out, _, clean_peak[route] = measured(f"clean/{route}",
                                             lambda: fn(clean))
        if out != F5_TEXT:
            raise AssertionError(f"corrupt clean/{route}: {out!r:.80}")
    decoded, writers = {"clean_legacy_peak_bytes": clean_peak}, {}
    decode_cuda.decode_units = spy
    try:
        for name, (bad, want) in f5_containers().items():
            for route, fn in routes.items():
                case = f"{name}/{route}"
                widths.clear()
                out, launches, over = measured(
                    case, lambda: fn(bad), limit=None if want is None
                    else 1 << 20)
                if want is not None:
                    if not isinstance(out, str) or want not in out \
                            or launches:
                        raise AssertionError(f"corrupt {case}: {out!r:.80}, "
                                             f"launches {launches}")
                    decoded[case] = {"error": out, "peak_bytes": over}
                elif (out != F5_TEXT or widths != [528]
                      or launches.get("decode_units") != 1
                      or over > clean_peak[route] + (1 << 20)):
                    raise AssertionError(f"corrupt {case}: {out!r:.80}, "
                                         f"K7 n_out {widths}, launches "
                                         f"{launches}, {over} bytes")
                else:
                    decoded[case] = {"decoded": len(out),
                                     "k7_n_out": widths[0],
                                     "launches": launches, "peak_bytes": over}
    finally:
        decode_cuda.decode_units = real_decode
    for bs in (0, 1 << 32):
        for route, fn in (
                ("api", lambda: api.compress(F5_TEXT, block_size=bs,
                                             device=dev)),
                ("hybrid", lambda: hybrid.compress(F5_TEXT, block_size=bs,
                                                   device=dev))):
            case = f"compress_block_size_{bs}/{route}"
            out, launches, over = measured(case, fn, limit=0)
            if not isinstance(out, str) or "block_size" not in out \
                    or launches or over:
                raise AssertionError(f"corrupt {case}: {out!r:.80}, launches "
                                     f"{launches}, {over} bytes")
            writers[case] = out
    return {"f5": decoded, "f5_writers": writers}


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


def http_post(url: str, body: bytes):
    """(reply body, its X-MHC-Seconds, the client's wall seconds)."""
    import urllib.request
    req = urllib.request.Request(url, data=body, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = r.read()
        codec_s = float(r.headers["X-MHC-Seconds"])
    return out, codec_s, time.perf_counter() - t0


def http_get(url: str) -> bytes:
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def phase_serve(torch, data: bytes, dev) -> None:
    """The codec service in this process on cuda:0 (`serve.make_server`,
    served from a thread after `serve.warmup`), its clients over
    urllib: the 100 MB corpus compressed in both modes (the reference
    containers) and decompressed (the corpus), the Markov pair counted
    (K1 and K3 once per chunk, the fused table build once, K13 never;
    K7m, its table build and K13 once per chunk); eight concurrent 1 MB clients (4 Markov, 4 order-0, one
    block of 1 MB), each reply the 1 MB reference; a garbage container
    (400); /healthz; /stats counting every request and error. Each
    request's client wall time beside its X-MHC-Seconds."""
    import threading
    import urllib.error
    from mhc_tpu_torch import api, serve
    from mhc_tpu_torch.utils.corpus import make_corpus
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve.warmup(device=dev)
    warmup_s = time.perf_counter() - t0
    srv = serve.make_server("127.0.0.1", 0, device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    n_chunks = len(api._chunks(0, -(-len(data) // api.DEFAULT_DECODE_UNIT),
                               api.DEFAULT_DECODE_UNIT))
    requests = {}
    try:
        for mode, ref_len, ref_sha in (
                ("markov", REF_100MB_LEN, REF_100MB_SHA256),
                ("huffman", REF_ORDER0_100MB_LEN, REF_ORDER0_100MB_SHA256)):
            (blob, c_s, c_wall), enc = run_counted(
                torch, lambda: http_post(f"{url}/compress?mode={mode}", data))
            check_container(f"serve /compress?mode={mode}", blob, ref_len,
                            ref_sha)
            (back, d_s, d_wall), dec = run_counted(
                torch, lambda: http_post(f"{url}/decompress", blob))
            if back != data:
                raise AssertionError(f"serve /decompress ({mode}) did not "
                                     "return the corpus")
            del back
            if mode == "markov":
                require_launches("serve /compress (Markov)", enc, {
                    "markov_hist": n_chunks, "pack_units": n_chunks,
                    "code_tables": 1, "code_lengths": 0,
                    "decode_units": 0, "canonical_tables": 0,
                    "compact_units": n_chunks, "expand_units": 0})
                require_launches("serve /decompress (Markov)", dec, {
                    "decode_units": n_chunks, "decode_lut": n_chunks,
                    "markov_hist": 0, "pack_units": 0, "code_lengths": 0,
                    "code_tables": 0, "canonical_tables": n_chunks,
                    "compact_units": 0, "expand_units": n_chunks,
                    "literal_rows": "some"})
            requests[f"compress_100mb_{mode}"] = {
                "client_wall_s": c_wall, "x_mhc_seconds": c_s,
                "launches": enc, "container_bytes": len(blob)}
            requests[f"decompress_100mb_{mode}"] = {
                "client_wall_s": d_wall, "x_mhc_seconds": d_s,
                "launches": dec}
        small = make_corpus(1 << 20)
        refs = {"markov": REF_1MB_SHA256, "huffman": REF_ORDER0_1MB_SHA256}
        clients = ["markov", "huffman"] * 4
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(clients)) as pool:
            replies = list(pool.map(lambda m: http_post(
                f"{url}/compress?mode={m}&block_size=1048576", small),
                clients))
        concurrent_wall = time.perf_counter() - t0
        for mode, (blob, _, _) in zip(clients, replies):
            if hashlib.sha256(blob).hexdigest() != refs[mode]:
                raise AssertionError(f"serve: a concurrent 1 MB {mode} "
                                     "reply is not the reference container")
        requests["compress_1mb_concurrent_8"] = {
            "modes": clients, "all_clients_wall_s": concurrent_wall,
            "client_wall_s": [r[2] for r in replies],
            "x_mhc_seconds": [r[1] for r in replies]}
        try:
            http_post(f"{url}/decompress", b"MHTC but not a container")
        except urllib.error.HTTPError as e:
            garbage = e.code
        else:
            garbage = 200
        if garbage != 400:
            raise AssertionError(f"serve: a garbage container got {garbage}")
        if http_get(f"{url}/healthz") != b"ok":
            raise AssertionError("serve: /healthz is not ok")
        stats = json.loads(http_get(f"{url}/stats"))
        sent = 4 + len(clients) + 1
        if stats["requests"] != sent or stats["errors"] != 1:
            raise AssertionError(f"serve: /stats {stats} after {sent} "
                                 "requests and 1 error")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    emit("serve", n_bytes=len(data), device=str(dev), warmup_s=warmup_s,
         n_chunks=n_chunks, requests=requests, garbage_status=garbage,
         stats=stats)


def start_group(cmd, **kw):
    """Popen in a session of its own, so that `stop_group` ends the
    command and every process it started."""
    return subprocess.Popen(cmd, cwd=REPO, start_new_session=True, **kw)


def stop_group(proc) -> None:
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def run_group(cmd, timeout: float, env=None):
    """(exit code, stdout, stderr, wall seconds) of `cmd`; on timeout its
    whole session is killed and the phase fails."""
    t0 = time.perf_counter()
    proc = start_group(cmd, env=env, stdout=subprocess.PIPE,
                       stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{cmd} ran over {timeout} s") from None
    finally:
        stop_group(proc)
    return proc.returncode, out, err, time.perf_counter() - t0


def phase_serve_cli() -> None:
    """`python -m mhc_tpu_torch.serve --port 0` as a user starts it: its
    warm-up and bound port read from its output, /healthz and a 1 MB
    round trip, then SIGINT, which must end it with exit 0; the wall
    time to `listening on`. Then the same command with no card visible
    (CUDA_VISIBLE_DEVICES empty) and no --device must exit non-zero with
    resolve_device's message: no CPU fallback."""
    import queue
    import signal
    import threading
    from mhc_tpu_torch.ops.kernels import _build
    from mhc_tpu_torch.utils.corpus import make_corpus
    cmd = [sys.executable, "-m", "mhc_tpu_torch.serve", "--port", "0"]
    lines: queue.Queue = queue.Queue()
    log_path = os.path.join(_build.BUILD_DIR, "serve_cli.stderr")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = start_group(cmd, stdout=subprocess.PIPE, stderr=log,
                           text=True)
    try:
        reader = threading.Thread(
            target=lambda: [lines.put(ln) for ln in proc.stdout],
            daemon=True)
        reader.start()
        out, deadline = [], time.monotonic() + 300
        while not (out and out[-1].startswith("mhc-serve listening on ")):
            try:
                out.append(lines.get(timeout=1).strip())
            except queue.Empty:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(
                        f"serve_cli: no `listening on` (exit "
                        f"{proc.poll()}); output {out}") from None
        startup_s = time.perf_counter() - t0
        warmup = next(ln for ln in out if ln.startswith("warmup done in "))
        port = int(out[-1].rsplit(":", 1)[1])
        url = f"http://127.0.0.1:{port}"
        if http_get(f"{url}/healthz") != b"ok":
            raise AssertionError("serve_cli: /healthz is not ok")
        small = make_corpus(1 << 20)
        blob, c_s, c_wall = http_post(
            f"{url}/compress?block_size=1048576", small)
        check_container("serve_cli /compress", blob, REF_1MB_LEN,
                        REF_1MB_SHA256)
        back, d_s, d_wall = http_post(f"{url}/decompress", blob)
        if back != small:
            raise AssertionError("serve_cli: /decompress did not return "
                                 "the input")
        proc.send_signal(signal.SIGINT)
        code = proc.wait(timeout=60)
        if code != 0:
            with open(log_path) as f:
                raise AssertionError(f"serve_cli: exit {code} after SIGINT:"
                                     f" {f.read()[-2000:]}")
    finally:
        stop_group(proc)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    no_card = run_group(cmd, 300, env=env)
    if (no_card[0] == 0 or "torch.cuda.is_available() is false"
            not in no_card[2] or "listening on" in no_card[1]):
        raise AssertionError(f"serve_cli without a card: exit {no_card[0]}"
                             f", stderr {no_card[2][-2000:]}")
    emit("serve_cli", startup_wall_s=startup_s, printed=out,
         warmup=warmup, compress_1mb={"client_wall_s": c_wall,
                                      "x_mhc_seconds": c_s},
         decompress_1mb={"client_wall_s": d_wall, "x_mhc_seconds": d_s},
         sigint_exit=code, no_card_exit=no_card[0],
         no_card_error=no_card[2].strip().splitlines()[-1],
         no_card_wall_s=no_card[3])


def trace_line(err: str, what: str) -> dict:
    lines = [ln for ln in err.splitlines()
             if ln.startswith(f"[mhc-trace {what}] ")]
    if len(lines) != 1:
        raise AssertionError(f"trace: {len(lines)} `mhc-trace {what}` "
                             "lines")
    return json.loads(lines[0].split("] ", 1)[1])


def phase_trace(torch, data: bytes, dev) -> None:
    """api.compress / api.decompress of the 100 MB Markov corpus with
    MHC_TRACE=1 (stderr captured) and without, in turns (traced,
    untraced, untraced, traced): the same container, the reference's;
    the traced phases of the faster traced call, the sum of their
    seconds beside that call's wall; the faster untraced call's wall."""
    import contextlib
    import io
    from mhc_tpu_torch import api
    torch.cuda.empty_cache()
    runs: dict = {"traced": [], "untraced": []}
    for traced in (True, False, False, True):
        err = io.StringIO()
        if traced:
            os.environ["MHC_TRACE"] = "1"
        try:
            with contextlib.redirect_stderr(err):
                blob, c = wall_s(torch, lambda: api.compress(data,
                                                             device=dev))
                back, d = wall_s(torch, lambda: api.decompress(blob,
                                                               device=dev))
        finally:
            os.environ.pop("MHC_TRACE", None)
        check_container(f"trace (traced={traced})", blob, REF_100MB_LEN,
                        REF_100MB_SHA256)
        if back != data:
            raise AssertionError("trace: api.decompress did not return "
                                 "the input")
        del back
        run = {"compress_s": c, "decompress_s": d}
        if traced:
            for what in ("compress", "decompress"):
                phases = trace_line(err.getvalue(), what)
                run[f"{what}_phases"] = phases
                run[f"{what}_phase_sum_s"] = sum(
                    p["seconds"] for p in phases.values())
        elif "mhc-trace" in err.getvalue():
            raise AssertionError("trace: an untraced call printed a trace")
        runs["traced" if traced else "untraced"].append(run)
    best = {k: min(v, key=lambda r: r["compress_s"] + r["decompress_s"])
            for k, v in runs.items()}
    emit("trace", n_bytes=len(data), mode="markov", **best)


def phase_profile(torch, data: bytes, dev, age_s: float) -> None:
    """metrics.torch_profile around engine.encode + engine.decode of the
    100 MB Markov corpus, run twice in one window: the trace file is
    written, and it names each kernel of the main path by its
    `__global__` name, with each one's device time and how many of its
    launches (two each: K13 now only on the decode) the trace holds. The first pass is there
    because torch.profiler on this machine loses the first kernels of a
    window,
    more of them the longer the process has run (PERF.md §7); `age_s`,
    the process's age at the window, is reported beside the count."""
    import glob
    import shutil
    from mhc_tpu_torch import engine
    from mhc_tpu_torch.ops.kernels import _build
    from mhc_tpu_torch.utils import metrics
    outdir = os.path.join(_build.BUILD_DIR, "profile")
    shutil.rmtree(outdir, ignore_errors=True)
    torch.cuda.empty_cache()
    st = engine.stage(data, device=dev)
    engine.decode(engine.encode(st))
    with metrics.torch_profile(outdir, dev):
        for _ in range(2):
            enc = engine.encode(st)
            out = engine.decode(enc)
    if engine.fetch_bytes(enc, out) != data:
        raise AssertionError("profile: the round trip is not bit-exact")
    (path,) = glob.glob(os.path.join(outdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    want = {"markov_hist": "markov_hist_kernel",
            "code_tables": "code_tables_kernel",
            "pack_units": "pack_units_kernel",
            "decode_lut": "decode_lut_kernel",
            "decode_units": "decode_units_kernel",
            "canonical_tables": "canonical_tables_kernel",
            "compact_units": "compact_units_kernel",
            "expand_units": "expand_units_kernel",
            "literal_rows": "literal_rows_kernel"}
    found = {}
    for name, fn in want.items():
        hits = [e for e in kernels if fn in e.get("name", "")]
        if not hits:
            raise AssertionError(f"profile: the trace does not name {fn}")
        found[name] = {"in_trace": len(hits), "launched": 2,
                       "device_us": [e.get("dur") for e in hits]}
    emit("profile", trace_file=os.path.relpath(path, REPO),
         trace_bytes=os.path.getsize(path), n_events=len(events),
         n_kernel_events=len(kernels), process_age_s=age_s, kernels=found)


def phase_dryrun() -> None:
    """`python -m mhc_tpu_torch.parallel.dryrun` as a user runs it: one
    rank (NCCL on cuda:0, the default on a card) and two gloo ranks
    sharing cuda:0."""
    import torch
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    runs = {}
    for args in (["--ranks", "1"], ["--ranks", "2", "--backend", "gloo"]):
        code, out, err, wall = run_group(
            [sys.executable, "-m", "mhc_tpu_torch.parallel.dryrun", *args],
            600, env=env)
        if code != 0:
            raise AssertionError(f"dryrun {args}: exit {code}: "
                                 f"{err[-3000:]}")
        runs[" ".join(args)] = {"wall_s": wall,
                                "stdout": out.strip().splitlines()}
    emit("dryrun", runs=runs)


def probe_bound(name: str, steps: int) -> dict:
    """The least time the card could take for body `name` (P2: one
    256 x 256 x 256 product; P1 and P3: `steps` steps of its loop): the
    largest of its operations at the card's peak rate for their type
    (int32 on the CUDA cores, or the tensor cores' int8 or bf16), its
    dependent chain (the integer ops a step must wait for, at INT_DEP_S;
    a shared-memory round trip at SMEM_CHAIN_S) and its bytes (the carry
    and the operands once each) at 3.35 TB/s."""
    probe, body = name.split("/", 1)
    lanes = 8 * 128
    moved = 2 * 4 * lanes
    ops_s = chain_s = 0.0
    if probe == "loop_calib":
        kind, n = body.rsplit("_", 1)
        # int32 ops of one op of the body, and its dependent depth
        ops, depth = {"chain": (3, 2 * INT_DEP_S),
                      "store": (3, 2 * INT_DEP_S),
                      "scratch": (1, SMEM_CHAIN_S + INT_DEP_S),
                      # and; 64 compares, selects and adds; the carry add.
                      # Depth: and, compare, select, a 3-input add tree
                      # over the 65 terms (4 levels)
                      "wide": (3 * 64 + 2, 7 * INT_DEP_S),
                      "dep1": (2, INT_DEP_S)}[kind]
        ops_s = steps * int(n) * ops * lanes / INT32_OPS_PER_S
        chain_s = steps * int(n) * depth
    elif probe == "mosaic_probe":
        ops_s = 2 * 256 ** 3 / TC_INT8_OPS_PER_S
        moved = 2 * 256 * 256 + 4 * 256 * 256
    elif body.startswith("fetch316_"):
        i8 = "_i8_" in body
        ops_s = steps * 2 * 316 * 256 * lanes / (TC_INT8_OPS_PER_S if i8
                                                 else TC_BF16_OPS_PER_S)
        moved += 256 * 316 * (1 if i8 else 2)
    elif body == "null_loop":
        ops_s = steps * 2 * lanes / INT32_OPS_PER_S
        chain_s = steps * 2 * INT_DEP_S
    else:
        # a compare, a select or product and an add for each of 256 k;
        # depth: compare, select, a 3-input add tree of 256 terms (6
        # levels), & 255
        ops_s = steps * 3 * 256 * lanes / INT32_OPS_PER_S
        chain_s = steps * 9 * INT_DEP_S
        if body.startswith("pick256_"):
            moved += 256 * 8 * (1 if "_i8" in body else 4)
    bytes_s = moved / HBM_BYTES_PER_S
    bound_s = max(ops_s, chain_s, bytes_s)
    return {"bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if bound_s == bytes_s else "operations",
            "held_to": ("chain_floor_ms" if bound_s == chain_s
                        else "ops_ms" if bound_s == ops_s else "bytes_ms"),
            "ops_ms": ops_s * 1e3, "chain_floor_ms": chain_s * 1e3,
            "bytes_ms": bytes_s * 1e3, "bound_bytes": moved}


def i8_matmul_4096(torch, dev, row: dict) -> None:
    """P2 once at 4096^3 beside torch._int_mm (recorded, not gated: how
    far the design gets toward the tensor cores' int8 rate): equal to its
    plain version and to torch._int_mm, bound by its operations at
    1,979 TOP/s."""
    import numpy as np
    from mhc_tpu_torch.bench import probes
    rng = np.random.default_rng(4096)
    a, b = (torch.from_numpy(rng.integers(-128, 128, (4096, 4096),
                                          np.int8)).to(dev)
            for _ in range(2))
    name, inputs = "mosaic_probe/i8_matmul", "4096x4096x4096"
    got = compare(torch, {name: row}, name, lambda: probes.i8_matmul(a, b),
                  lambda: probes.i8_matmul_plain(a, b), 5, 1, inputs,
                  bound_bytes=lambda out: nbytes(a, b, *out),
                  library=lambda: torch._int_mm(a, b))[0]
    same = bool(torch.equal(got, torch._int_mm(a, b)))
    on = row["on_inputs"][inputs]
    ops_ms = 2 * 4096 ** 3 / TC_INT8_OPS_PER_S * 1e3
    on.update(ops_ms=ops_ms, bytes_ms=on["bound_ms"],
              bound_ms=max(ops_ms, on["bound_ms"]),
              bound_by="operations" if ops_ms > on["bound_ms"] else "bytes",
              equal_to_int_mm=same)
    on.update(shares(on["bound_ms"], on["ms"], on["device_ms"]))
    if on["device_ms"]:
        on["device_tops"] = 2 * 4096 ** 3 / on["device_ms"] / 1e9
    emit("kernel", check="i8_matmul == torch._int_mm at 4096^3", equal=same,
         device_ms=on["device_ms"], library_device_ms=on["library_device_ms"],
         bound_ms=on["bound_ms"], bound_by=on["bound_by"])
    if not same:
        raise AssertionError("i8_matmul differs from torch._int_mm at 4096^3")


def reference_plains(out_path: str) -> None:
    """The worker of `chip_smoke.py --reference-plains OUT`: every P1 and
    P3 body's plain version on the CPU at the reference's steps (P1
    4,096, P3 1,024, its fetch cores 256), saved to OUT (npz, one array a
    body, `/` written `__`). Started beside the first phases: the longest
    chains take ~110 s of one core as step loops of tensor ops."""
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    from mhc_tpu_torch.bench import probes
    cpu = torch.device("cpu")
    res = {}
    for body in PROBE_BODIES["loop_calib"][1]:
        variant, n_ops = {**probes.LOOP_BODIES, **probes.DEP_BODIES}[body]
        res[f"loop_calib__{body}"] = probes.loop_calib_plain(
            variant, n_ops, probes.loop_input(cpu), probes.LOOP_ITERS)
    for body in PROBE_BODIES["vpu_probe"][1]:
        res[f"vpu_probe__{body}"] = probes.vpu_probe_plain(
            body, probes.vpu_input(cpu),
            probes.vpu_steps(body, probes.VPU_ITERS),
            probes.vpu_operand(body, cpu))
    np.savez(out_path, **{k: v.numpy() for k, v in res.items()})


def start_reference_plains(path: str):
    """The `--reference-plains` worker in a process of its own."""
    return start_group([sys.executable, os.path.abspath(__file__),
                        "--reference-plains", path],
                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                       text=True)


def read_reference_plains(proc, path: str) -> dict:
    """{body: plain output} of the worker, once it has ended."""
    import numpy as np
    try:
        _, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        raise AssertionError("--reference-plains ran over 900 s") from None
    if proc.returncode != 0:
        raise AssertionError(f"--reference-plains: exit {proc.returncode}:"
                             f" {err[-3000:]}")
    with np.load(path) as f:
        return {k.replace("__", "/", 1): f[k] for k in f.files}


def phase_probes(torch, dev, rows: dict, plains: dict) -> dict:
    """P1-P3: every body's kernel against its plain version on the card
    at 1 and 64 steps (tolerance 0; P2's product also against
    torch._int_mm, the library column, and an int64 product on the host);
    each loop body at the reference's steps (loop_calib 4,096, vpu_probe
    1,024, its fetch cores 256): its output equal (tolerance 0) to the
    plain version's at those steps (`plains`, computed on the CPU by the
    `--reference-plains` worker), timed per call over KERNEL_BATCH calls
    as the kernel rows are, its device time not under its bound (a
    share above 1.05 would mean work the bound counts was skipped), and
    its loop's clock64() cycles at those steps and a sixteenth of them,
    which must grow by 4x at least (no step folded or hoisted; the
    launch's fixed cost is not in the cycles). Returns {body: {"steps",
    "chk"}} at the reference's steps, for the entry points' check."""
    import numpy as np
    from mhc_tpu_torch.bench import probes
    full = {}
    a, b = probes.i8_matmul_inputs(dev)
    name = "mosaic_probe/i8_matmul"
    (got,) = compare(torch, rows, name, lambda: probes.i8_matmul(a, b),
                     lambda: probes.i8_matmul_plain(a, b), 10, 3,
                     "256x256x256", bound_bytes=lambda out: nbytes(a, b, *out),
                     library=lambda: torch._int_mm(a, b))
    exact = a.cpu().numpy().astype(np.int64) @ b.cpu().numpy().astype(
        np.int64)
    same = (bool(torch.equal(got, torch._int_mm(a, b)))
            and bool((got.cpu().numpy() == exact).all()))
    emit("kernel", check="i8_matmul == torch._int_mm == int64 product",
         equal=same)
    if not same:
        raise AssertionError("i8_matmul differs from torch._int_mm or the "
                             "int64 product")
    rows[name].update(probe_bound(name, 1))
    rows[name].update(shares(rows[name]["bound_ms"], rows[name]["ms"],
                             rows[name]["device_ms"]))
    i8_matmul_4096(torch, dev, rows[name])

    def loop_run(body, x, steps, cycles=None):
        return probes.loop_calib(body, x, steps, cycles)

    def loop_plain(body, x, steps):
        variant, n_ops = {**probes.LOOP_BODIES, **probes.DEP_BODIES}[body]
        return probes.loop_calib_plain(variant, n_ops, x, steps)

    def vpu_run(body, x, steps, cycles=None):
        return probes.vpu_probe(body, x, steps,
                                probes.vpu_operand(body, dev), cycles)

    def vpu_plain(body, x, steps):
        return probes.vpu_probe_plain(body, x, steps,
                                      probes.vpu_operand(body, dev))

    for probe, run, plain, x, iters in (
            ("loop_calib", loop_run, loop_plain, probes.loop_input(dev),
             probes.LOOP_ITERS),
            ("vpu_probe", vpu_run, vpu_plain, probes.vpu_input(dev),
             probes.VPU_ITERS)):
        for body in PROBE_BODIES[probe][1]:
            name = f"{probe}/{body}"
            for steps in (1, 64):
                compare(torch, rows, name,
                        lambda: run(body, x, steps),
                        lambda: plain(body, x, steps), 3, 1,
                        f"steps_{steps}",
                        bound_bytes=lambda out: nbytes(x, *out))
            steps = (probes.vpu_steps(body, iters) if probe == "vpu_probe"
                     else iters)
            out, ms = min_ms(torch, lambda: run(body, x, steps), 3,
                             KERNEL_BATCH)
            ref_err = int(np.abs(out.cpu().numpy().astype(np.int64)
                                 - plains[name].astype(np.int64)).max())
            if ref_err != 0:
                raise AssertionError(
                    f"{name} differs from its plain version at {steps} "
                    f"steps (max abs err {ref_err}); tolerance is 0")
            dev_ms = device_fields(torch, lambda: run(body, x, steps), 3,
                                   KERNEL_BATCH, "device_ms")
            cycles = {}
            for n in (steps // 16, steps):
                c = torch.zeros(1, dtype=torch.int64, device=dev)
                run(body, x, n, c)
                cycles[n] = int(c.cpu())
            growth = cycles[steps] / max(cycles[steps // 16], 1)
            row = rows[name]
            row.update(probe_bound(name, steps))
            row["on_inputs"][f"steps_{steps}"] = {
                "max_abs_err": ref_err, "plain_on": "cpu"}
            row.update(ms=ms, **dev_ms, steps=steps,
                       plain_ms=row["on_inputs"]["steps_64"]["plain_ms"],
                       plain_steps=64, library_ms=None,
                       library_device_ms=None,
                       **shares(row["bound_ms"], ms, dev_ms["device_ms"]),
                       loop_cycles={str(k): v for k, v in cycles.items()},
                       cycles_growth_x16=growth)
            full[name] = {"steps": steps, "chk": int(out.long().sum())}
            emit("probe", kernel=name, steps=steps, ms=ms,
                 max_abs_err_at_steps=ref_err,
                 device_ms=row["device_ms"], bound_ms=row["bound_ms"],
                 device_share_of_bound=row["device_share_of_bound"],
                 held_to=row["held_to"],
                 loop_cycles=row["loop_cycles"], cycles_growth_x16=growth)
            share = row["device_share_of_bound"]
            if share is not None and share > 1.05:
                raise AssertionError(
                    f"{name}: device time {row['device_ms']} ms is under "
                    f"its bound {row['bound_ms']} ms (share {share:.3f}): "
                    "the kernel skips work the bound counts")
            if growth < 4:
                raise AssertionError(
                    f"{name}: the loop's cycles grew {growth:.2f}x from "
                    f"{steps // 16} to {steps} steps (at least 4x wanted): "
                    "steps were folded or hoisted")
    return full


def phase_probe_entry_points(full: dict) -> dict:
    """`python -m mhc_tpu_torch.bench.loop_calib`, `.mosaic_probe` and
    `.vpu_probe` as a user runs them, each in a subprocess: exit 0, one
    JSON line, every body's kernel launched (its own counters, from 0 in
    the fresh process), each loop body's `chk` equal to the kernel's in
    this process at the same steps, P2's checks true. Returns each
    probe's JSON line."""
    results = {}
    for probe, (_, bodies) in PROBE_BODIES.items():
        code, out, err, wall = run_group(
            [sys.executable, "-m", f"mhc_tpu_torch.bench.{probe}"], 600)
        if code != 0:
            raise AssertionError(f"{probe}: exit {code}: {err[-3000:]}")
        res = json.loads(out.strip().splitlines()[-1])
        emit("probe_entry", probe=probe, wall_s=wall, result=res)
        for body in bodies:
            name = f"{probe}/{body}"
            if res["launches"].get(name, 0) < 1:
                raise AssertionError(f"{probe}: {name} was not launched "
                                     f"({res['launches']})")
            if name in full and res[body]["chk"] != full[name]["chk"]:
                raise AssertionError(f"{probe}: {body} chk {res[body]['chk']}"
                                     f" != the kernel's {full[name]['chk']}")
        if res["platform"] != "gpu" or (
                probe == "mosaic_probe"
                and not (res["i8_matmul"] is True
                         and res["hist_pallas_ok"] is True
                         and res["launches"].get("markov_hist", 0) >= 1)):
            raise AssertionError(f"{probe}: {res}")
        results[probe] = res
    return results


def event_ms(torch, fn):
    """(fn()'s result, ms of that one call between CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def multigb_files(path: str, seg_mb: int, ref_len: int,
                  ref_sha: str) -> dict:
    """`python -m mhc_tpu_torch.bench.multigb --input path` at `seg_mb`
    MB segments in a subprocess (its peak RSS its own), its temporary
    files under the build directory: the round trip byte-equal, and the
    chained containers the JAX reference's. Returns its JSON line."""
    from mhc_tpu_torch.ops.kernels import _build
    r = subprocess.run(
        [sys.executable, "-m", "mhc_tpu_torch.bench.multigb", "2.25",
         str(seg_mb), "--input", path], cwd=REPO, capture_output=True,
        text=True, timeout=600, env={**os.environ, "TMPDIR": _build.BUILD_DIR})
    lines = r.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    if r.returncode != 0 or res is None or not res["roundtrip_ok"]:
        raise AssertionError(f"multigb {seg_mb} MB exited {r.returncode}: "
                             f"{r.stdout[-1000:]} {r.stderr[-2000:]}")
    emit("multigb_files", **res)
    if (res["compressed_bytes"], res["sha256"]) != (ref_len, ref_sha):
        raise AssertionError(
            f"multigb {seg_mb} MB: chain ({res['compressed_bytes']} B, "
            f"{res['sha256']}) differs from the JAX reference's ({ref_len} "
            f"B, {ref_sha})")
    os.remove(os.path.join(_build.BUILD_DIR, "mhc_multigb.mhc"))
    return res


def multigb_engine(torch, x: bytes, mode: str, dev, name: str,
                   want: dict, route, check=None) -> dict:
    """engine.stage -> encode -> decode -> fetch_bytes ->
    assemble_container of `x`, the encode and decode after one warm-up
    pass counted and held to `want` and timed by CUDA events, the peak
    device bytes those two's (the staged units in); the round trip
    exact and the container
    equal to route(), an independent route's; check(staged units), where
    given, adds its fields. Returns the case's fields."""
    from mhc_tpu_torch import engine
    torch.cuda.empty_cache()
    st = engine.stage(x, mode=mode, device=dev)
    # a warm-up pass, so that the timed one meets the card's clocks up
    # and its allocator holding the blocks (without it the Markov encode
    # of the tiled corpus took 153 ms, the zeros' 26 ms, on an NVIDIA
    # H100 80GB HBM3 at 700 W)
    engine.decode(engine.encode(st))
    torch.cuda.reset_peak_memory_stats()

    def drive():
        enc, enc_ms = event_ms(torch, lambda: engine.encode(st))
        out, dec_ms = event_ms(torch, lambda: engine.decode(enc))
        return enc, out, enc_ms, dec_ms

    (enc, out, enc_ms, dec_ms), launches = run_counted(torch, drive)
    peak = torch.cuda.max_memory_allocated()
    require_launches(f"multigb {name}", launches, want)
    more = check(st) if check else {}
    n_units, du = st.n_units, st.decode_unit
    del st
    if engine.fetch_bytes(enc, out) != x:
        raise AssertionError(f"multigb {name}: round trip is not exact")
    del out
    blob = engine.assemble_container(enc, zlib.crc32(x) & 0xFFFFFFFF)
    del enc
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    same = route() == blob
    route_s = time.perf_counter() - t0
    if not same:
        raise AssertionError(f"multigb {name}: the engine's container "
                             "differs from the independent route's")
    return {"mode": mode, "n_bytes": len(x), "n_units": n_units,
            "decode_unit": du,
            "launches": {k: v for k, v in launches.items() if v},
            "encode_ms": enc_ms, "decode_ms": dec_ms,
            "encode_GBps": len(x) / enc_ms / 1e6,
            "decode_GBps": len(x) / dec_ms / 1e6,
            "peak_device_bytes": peak, "container_bytes": len(blob),
            "sha256": hashlib.sha256(blob).hexdigest(),
            "route_s": route_s, **more}


def phase_multigb(torch, data: bytes, dev) -> None:
    """BASELINE config 5 at its real size, MULTIGB_BYTES (2.25 GiB):
    (a) the 100 MB corpus tiled to it, written once under the build
    directory; (b) that file through `python -m
    mhc_tpu_torch.bench.multigb` at the file API's 1 GiB segments and at
    256 MB (subprocesses, each peak RSS its own): round trips exact, the
    chains the JAX reference's digests, the 256 MB run's peak RSS over
    its process's base (the card's context and libraries) under the
    file's size; (c) the device-resident engine past 2**31 bytes,
    each case counted, timed and round-tripped: (i) the tiled corpus,
    Markov, held to api.compress (the chunked route); (ii) zeros, Markov
    and order-0, whose one cell (0, 0) / byte 0 counts MULTIGB_BYTES
    (past int32: F7): engine.histogram equal to the native host counts,
    and the container to the native host route's (hybrid at
    host_fraction 1.0) and to hybrid's device route (0.0); (iii) seeded
    noise, order-0, every unit literal and the payload past 2**31
    bytes, held to api.compress."""
    from mhc_tpu_torch.ops.kernels import _build
    from mhc_tpu_torch.utils.corpus import tiled_corpus
    started = time.perf_counter()
    n = MULTIGB_BYTES
    tiled = tiled_corpus(n, CORPUS_BYTES, tile=data)
    path = os.path.join(_build.BUILD_DIR, "multigb_tiled.bin")
    with open(path, "wb") as f:
        f.write(tiled)
    del tiled
    write_s = time.perf_counter() - started
    files = {1024: multigb_files(path, 1024, REF_MULTIGB_SEG1G_LEN,
                                 REF_MULTIGB_SEG1G_SHA256),
             256: multigb_files(path, 256, REF_MULTIGB_SEG256M_LEN,
                                REF_MULTIGB_SEG256M_SHA256)}
    os.remove(path)
    # what the run adds to the resident set of a process that holds the
    # card follows the segment; the base alone (the CUDA context and
    # libraries: about 5 GB beside an NVIDIA H100 80GB HBM3 at 700 W,
    # PERF.md) is more than the file
    grown = files[256]["peak_rss_over_base_GB"]
    if grown is None or grown * 1e9 >= n:
        raise AssertionError(
            f"multigb 256 MB: the peak RSS grew {grown} GB over the "
            f"process's base, not under the file's {n} bytes")
    files_s = time.perf_counter() - started - write_s
    from mhc_tpu_torch.bench.multigb import PeakRss
    with PeakRss() as rss:
        cases = multigb_engine_cases(torch, data, dev)
    emit("multigb", n_bytes=n, write_s=write_s, files_s=files_s,
         engine_cases_peak_rss_GB=rss.peak / 1e9,
         peak_rss_GB={k: v["peak_rss_GB"] for k, v in files.items()},
         peak_rss_over_base_GB={k: v["peak_rss_over_base_GB"]
                                for k, v in files.items()},
         engine=cases, seconds=time.perf_counter() - started)


def multigb_engine_cases(torch, data: bytes, dev) -> dict:
    """The multigb phase's engine cases (i)-(iii) on MULTIGB_BYTES, (i)
    on the 100 MB corpus `data` tiled. Returns each case's fields."""
    from mhc_tpu_torch import api, engine, hybrid
    from mhc_tpu_torch.utils import native
    from mhc_tpu_torch.utils.corpus import tiled_corpus
    import numpy as np
    n = MULTIGB_BYTES
    tiled = tiled_corpus(n, CORPUS_BYTES, tile=data)
    rt = {"canonical_tables": "once", "expand_units": "once",
          "code_tables": "once", "code_lengths": "none",
          "compact_units": "once"}
    cases = {}
    cases["corpus_markov"] = multigb_engine(
        torch, tiled, "markov", dev, "corpus_markov",
        {**rt, "markov_hist": "once", "pack_units": "once",
         "decode_lut": "once", "decode_units": "once",
         "literal_rows": "once"},
        lambda: api.compress(tiled, device=dev))
    del tiled
    zeros = bytes(n)

    def counts_check(st) -> dict:
        """engine.histogram (K1 / K2) == the native host counts, whose
        first cell holds every byte."""
        flat = np.frombuffer(zeros, np.uint8)
        host = (native.hist_markov(flat, st.decode_unit)
                if st.mode == "markov" else native.hist_order0(flat))
        counts = engine.histogram(st)
        first = (int(counts.reshape(-1)[0]), int(host.reshape(-1)[0]))
        if not np.array_equal(counts, host) or first != (n, n):
            raise AssertionError(
                f"multigb zeros {st.mode}: the card's counts differ from "
                f"the native host counts (first cell {first}, want {n})")
        return {"first_cell_count": first[0],
                "native_first_cell_count": first[1]}

    for mode, hist, dec in (("markov", "markov_hist", "decode_units"),
                            ("huffman", "order0_hist",
                             "decode_units_order0")):
        name = f"zeros_{mode}"
        lut = dec.replace("decode_units", "decode_lut")
        case = multigb_engine(
            torch, zeros, mode, dev, name,
            {**rt, hist: "once", "pack_units": "once", lut: "once",
             dec: "once", "literal_rows": "none"},
            lambda: hybrid.compress(zeros, mode=mode, host_fraction=1.0,
                                    device=dev), counts_check)
        # hybrid's device route: its prefix's counts from the card (K1/K2)
        blob, s = wall_s(torch, lambda: hybrid.compress(
            zeros, mode=mode, host_fraction=0.0, device=dev))
        if hashlib.sha256(blob).hexdigest() != case["sha256"]:
            raise AssertionError(f"multigb {name}: hybrid's device route "
                                 "differs from the native host route")
        cases[name] = {**case, "hybrid_device_s": s}
    del zeros
    noise = np.random.default_rng(MULTIGB_NOISE_SEED).bytes(n)
    cases["noise_order0"] = multigb_engine(
        torch, noise, "huffman", dev, "noise_order0",
        {**rt, "order0_hist": "once", "pack_units": "once",
         "decode_lut_order0": "once", "decode_units_order0": "once",
         "literal_rows": "once"},
        lambda: api.compress(noise, mode="huffman", device=dev))
    del noise
    torch.cuda.empty_cache()
    return cases


def run_phases(torch, plains, plains_path: str, started: float) -> dict:
    """Every phase after the build, on cuda:0; the `kernels` line's rows
    (`plains`: the `--reference-plains` worker writing `plains_path`;
    `started`: the run's start on the host clock)."""
    from mhc_tpu_torch.ops.kernels import _build
    from mhc_tpu_torch.utils.corpus import make_corpus
    dev = torch.device("cuda:0")
    rows: dict = {}
    data = make_corpus(CORPUS_BYTES)
    phase_k11_synthetic(torch, dev)
    phase_kernels_markov(torch, data, dev, rows)
    phase_kernels_payload_route(torch, data, dev, rows)
    phase_kernels_order0(torch, data, dev, rows)
    markov_blob, launches = round_trip(
        torch, data, "markov", dev, "main_path",
        {"markov_hist": "once", "pack_units": "once", "decode_lut": "once",
         "decode_units": "once", **STAGES_ROUND_TRIP},
        REF_100MB_LEN, REF_100MB_SHA256)
    dense_launches = phase_split_path(
        torch, data, dev, "dense",
        {"lookup_cl": "once", "pack_cl": "once", "pack_units": "none",
         **STAGES_ENCODE})
    pallas_launches = phase_split_path(
        torch, data, dev, "pallas",
        {"lookup_cl": "once", "bubble_pack": "once", "pack_units": "none",
         "pack_cl": "none", "compact_bubbles": "once",
         "bubbles_to_payload": "none", **STAGES_ENCODE})
    du64k_blob, payload_launches = phase_payload_route(torch, data, dev)
    order0_blob, order0_launches = round_trip(
        torch, data, "huffman", dev, "order0_path",
        {"order0_hist": "some", "pack_units": "some",
         "decode_lut_order0": "some", "decode_units_order0": "some",
         "markov_hist": "none", **STAGES_ROUND_TRIP},
        REF_ORDER0_100MB_LEN, REF_ORDER0_100MB_SHA256)
    phase_order0_pallas(torch, data, dev)
    lengths_only_launches = phase_breakdown(torch, data, dev)
    phase_redesign_turns(torch, data, dev)
    phase_small(torch, dev)
    phase_param_grid(torch, dev)
    phase_host_bytes(torch, data, dev)
    corpus_path = os.path.join(_build.BUILD_DIR, "corpus_100mb.bin")
    with open(corpus_path, "wb") as f:
        f.write(data)
    phase_cli(torch, corpus_path, data)
    phase_hybrid(torch, data, dev)
    phase_sharded(torch, corpus_path)
    phase_corrupt(torch, markov_blob, data, du64k_blob, dev)
    phase_oracle({"em": markov_blob, "e0": order0_blob}, corpus_path)
    phase_serve(torch, data, dev)
    phase_serve_cli()
    phase_trace(torch, data, dev)
    phase_profile(torch, data, dev, time.perf_counter() - started)
    phase_dryrun()
    entry = phase_probe_entry_points(phase_probes(
        torch, dev, rows, read_reference_plains(plains, plains_path)))
    calib = entry["loop_calib"]
    emit("probe_findings", loop_fit=calib["fit"],
         int_dep_ns_per_op=calib["int_dep_ns_per_op"],
         int_dep_ns_in_use=INT_DEP_S * 1e9,
         fetch_vs_pick_us_per_step={
             b: entry["vpu_probe"][b]["us_per_iter"]
             for b in ("fetch316_i8_matmul", "fetch316_bf16_matmul",
                       "pick256_i32", "pick256_i8mul_i32sum")})
    phase_multigb(torch, data, dev)
    # each kernel's launches on the path that runs it (K3: the main path;
    # the order-0 path's launches are in its own line; K11 alone: one
    # `EntropyModel.lengths_for` call, the encode's build being the fused
    # one)
    path_of = {"order0_hist": order0_launches,
               "decode_units_order0": order0_launches,
               "decode_lut_order0": order0_launches,
               "lookup_cl": dense_launches, "pack_cl": dense_launches,
               "bubble_pack": pallas_launches,
               "compact_bubbles": pallas_launches,
               "bubbles_to_payload": payload_launches,
               "code_lengths": lengths_only_launches}
    for probe, res in entry.items():    # a probe's bodies: its entry point
        path_of.update({name: res["launches"] for name in res["launches"]
                        if name.startswith(f"{probe}/")})
    for name, row in rows.items():
        row["launches"] = path_of.get(name, launches)[name]
    if set(rows) != set(KERNELS):
        raise AssertionError(f"kernels unchecked: {set(KERNELS) - set(rows)}")
    return rows


def main() -> int:
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs only on a CUDA GPU")
    sys.path.insert(0, REPO)
    from mhc_tpu_torch.ops.kernels import _build
    smi = phase_device(torch)
    phase_build(("histogram", "encode", "decode", "huffman", "tables",
                 "stages", "probes"))
    plains_path = os.path.join(_build.BUILD_DIR, "probe_plains.npz")
    plains = start_reference_plains(plains_path)
    try:
        rows = run_phases(torch, plains, plains_path, started)
    finally:
        stop_group(plains)
    print(smi, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_worker(sys.argv[2:])
        sys.exit(0)
    if sys.argv[1:2] == ["--reference-plains"]:
        reference_plains(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
