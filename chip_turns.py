#!/usr/bin/env python3
"""K1 and K2 of this tree against an earlier tree's, on one CUDA card, and
F7's input through that earlier tree.

    git archive <commit> mhc_tpu_torch native | tar -x -C build/parent
    python3 chip_turns.py build/parent

1. F7: chip_turns.py runs itself from the earlier tree (`--f7`, a
   subprocess with that tree's package): 2**31 + 2**28 + 12,345 bytes of
   zeros through `engine.stage` and `engine.histogram`, both modes, the
   first cell beside the native host count; then `engine.encode` /
   `decode` / `assemble_container` and `hybrid.compress` at
   host_fraction 0.0 against the native host route (1.0), each outcome
   printed (an exception's message included: the earlier tree may fail).
2. Turns: the earlier tree's `csrc/histogram.cu` built by nvcc into
   build/, and its K1 and K2 C entry points (int32 tables, no scratch)
   timed against this tree's wrappers on the 100 MB corpus's units,
   old, new, new, old three times: `device_ms` from 10 calls replayed
   from a CUDA graph and `ms` from 10 calls back to back
   (`chip_smoke.graph_ms` / `min_ms`), the minimum and every turn; the
   two outputs checked equal.
One JSON line each. Imports nothing of JAX or the reference.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
F7_BYTES = (1 << 31) + (1 << 28) + 12_345


def f7_on_this_tree() -> None:
    """F7's zeros through the package on sys.path (run from that tree)."""
    import numpy as np
    import torch
    from mhc_tpu_torch import engine, hybrid
    from mhc_tpu_torch.utils import native
    zeros = bytes(F7_BYTES)
    flat = np.frombuffer(zeros, np.uint8)
    for mode in ("markov", "huffman"):
        res = {"f7": mode}
        st = engine.stage(zeros, mode=mode, device="cuda")
        counts = engine.get_model(mode).histogram(st.units, st.n_valid)
        host = (native.hist_markov(flat, st.decode_unit) if mode == "markov"
                else native.hist_order0(flat))
        res.update(card_dtype=str(counts.dtype),
                   card_first_cell=int(counts.reshape(-1)[0]),
                   native_first_cell=int(host.reshape(-1)[0]),
                   counts_equal=bool(np.array_equal(
                       counts.cpu().numpy(), host)))
        blob = None
        try:
            enc = engine.encode(st)
            res["engine_round_trip"] = (
                engine.fetch_bytes(enc, engine.decode(enc)) == zeros)
            blob = engine.assemble_container(enc, zlib.crc32(zeros))
            del enc
        except Exception as e:      # the earlier tree's outcome, recorded
            res["engine_error"] = f"{type(e).__name__}: {e}"[:300]
        del st
        torch.cuda.empty_cache()
        ref = hybrid.compress(zeros, mode=mode, host_fraction=1.0,
                              device="cuda")
        res.update(native_route_bytes=len(ref),
                   engine_equals_native_route=blob == ref)
        try:
            dev_route = hybrid.compress(zeros, mode=mode, host_fraction=0.0,
                                        device="cuda")
            res.update(hybrid_device_bytes=len(dev_route),
                       hybrid_device_equals_native_route=dev_route == ref)
        except Exception as e:
            res["hybrid_device_error"] = f"{type(e).__name__}: {e}"[:300]
        print(json.dumps(res), flush=True)


def turns(parent: str) -> None:
    import torch
    import chip_smoke as cs
    from mhc_tpu_torch import engine
    from mhc_tpu_torch.ops.kernels import _build, histogram_cuda
    from mhc_tpu_torch.utils.corpus import make_corpus
    so = os.path.join(_build.BUILD_DIR, "earlier_histogram.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(parent, "mhc_tpu_torch", "csrc",
                                     "histogram.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"chip_turns: nvcc failed:\n{r.stderr}")
    lib = ctypes.CDLL(so)
    data = make_corpus(cs.CORPUS_BYTES)
    dev = torch.device("cuda:0")
    for mode, fname, shape, new in (
            ("markov", "mhc_markov_hist", (256, 256),
             histogram_cuda.markov_hist),
            ("huffman", "mhc_order0_hist", (256,),
             histogram_cuda.order0_hist)):
        fn = getattr(lib, fname)
        fn.argtypes = histogram_cuda._ARGTYPES
        fn.restype = ctypes.c_int
        st = engine.stage(data, mode=mode, device=dev)
        u, nv = st.units, st.n_valid

        def old():
            out = torch.zeros(shape, dtype=torch.int32, device=dev)
            _build.check(lib, fn(u.data_ptr(), nv.data_ptr(), u.shape[0],
                                 u.shape[1], out.data_ptr(),
                                 _build.stream_ptr(dev)), fname)
            return out

        fns = {"old": old, "new": lambda: new(u, nv)}
        equal = torch.equal(old().long(), new(u, nv))
        got = {k: {"device_ms": [], "ms": []} for k in fns}
        for turn in ("old", "new", "new", "old") * 3:
            got[turn]["device_ms"].append(
                cs.graph_ms(torch, fns[turn], 10, 10)[0])
            got[turn]["ms"].append(cs.min_ms(torch, fns[turn], 3, 10)[1])
        print(json.dumps({
            "turns": mode, "equal": equal,
            **{k: {m: min(v) for m, v in d.items()} for k, d in got.items()},
            "every_turn": got}), flush=True)
        del st, u, nv


def main() -> int:
    if sys.argv[1:2] == ["--f7"]:
        sys.path.insert(0, os.getcwd())
        f7_on_this_tree()
        return 0
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        raise SystemExit("usage: python3 chip_turns.py EARLIER_TREE "
                         "(on a CUDA card)")
    parent = os.path.abspath(sys.argv[1])
    sys.path.insert(0, REPO)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--f7"],
                       cwd=parent, capture_output=True, text=True,
                       timeout=900)
    print(r.stdout.strip(), flush=True)
    if r.returncode != 0:
        raise SystemExit(f"chip_turns: the earlier tree's F7 run exited "
                         f"{r.returncode}:\n{r.stderr[-3000:]}")
    print(json.dumps({"f7_s": time.perf_counter() - t0}), flush=True)
    turns(parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
