"""BASELINE config 5 on one card: a multi-GB file through the chained
segments of the file functions, round trip and peak memory (the
counterpart of the reference's bench/multigb.py).

    python -m mhc_tpu_torch.bench.multigb [GB] [segment_MB]
        [--input PATH] [--device cuda:0 | cpu]

Streams a file through `api.compress_file` and `api.decompress_file`
(each segment one independent container: the two-pass histogram, one
table build and the chunked encode), compares the round trip in 16 MB
reads, never holding the whole file, and prints one JSON line with the
reference's keys (`bytes`, `segment_mb`, `n_segments`, `ratio`,
`encode_s`, `decode_s`, `encode_MBps`, `decode_MBps`, `roundtrip_ok`,
`peak_rss_GB`) and the port's: the card's name and power limit, the
peak device bytes of the compress and of the decompress, the table
builder, the seconds per segment (each call's seconds over its
segments), the chained container's length and sha256, and the kernel
launches of each call. Exits 1 when the round trip fails.

The input is `--input`, or by default GB (2.0) of the reference's own
input, byte for byte: 256 MB pieces of `utils.corpus.make_corpus(seed=100
+ k)`, written once to the temporary directory and kept there by size.
The segment defaults to the file API's, 1024 MB (the reference's script
defaults to 256). Peak RSS (`peak_rss_GB`) is the highest resident set
(`VmRSS`, pinned host buffers in) sampled every 5 ms from the warm-up to
the end of the comparison; `rss_base_GB` is the resident set after the
warm-up (the card's context, PyTorch's CUDA libraries and the kernel
libraries), and `peak_rss_over_base_GB` what the run added to it, the
part that grows with the segment. Neither VmHWM nor ru_maxrss serves:
some kernels' /proc has no VmHWM, and exec after a (v)fork carries the
parent's high-water mark into the child's ru_maxrss (where /proc is
absent, ru_maxrss is reported all the same).

Runs on the first CUDA card, or where `--device` says; without a card
and without `--device cpu` it exits 1 before any work.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import sys
import tempfile
import threading
import time

import torch

from .. import api
from ..config import resolve_device
from ..ops.kernels import _build
from ..utils import native
from ..utils.corpus import make_corpus
from . import probes

PIECE_BYTES = 256 << 20      # the reference's corpus piece
READ_BYTES = 16 << 20        # the round trip's comparison reads


def default_input(n_gb: float) -> str:
    """The reference's input of `n_gb` GB (its file name and bytes), in
    the temporary directory; written when missing or of another size."""
    n_bytes = int(n_gb * (1 << 30))
    path = os.path.join(tempfile.gettempdir(), f"mhc_multigb_{n_gb}g.bin")
    if os.path.exists(path) and os.path.getsize(path) == n_bytes:
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        for k, lo in enumerate(range(0, n_bytes, PIECE_BYTES)):
            f.write(make_corpus(min(PIECE_BYTES, n_bytes - lo),
                                seed=100 + k))
    os.replace(tmp, path)
    return path


def rss_bytes() -> int | None:
    """The process's resident set now (VmRSS of /proc/self/status), None
    where /proc has none."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


class PeakRss:
    """The highest `rss_bytes()` sampled every `interval` seconds on a
    thread while the block runs (`peak`; ru_maxrss where there is no
    /proc)."""

    def __init__(self, interval: float = 0.005):
        self.interval = interval
        self.peak = rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self) -> None:
        while not self._stop.wait(self.interval):
            self.peak = max(self.peak, rss_bytes())

    def __enter__(self):
        if self.peak is not None:
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self.peak is None:
            self.peak = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024
            return
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def same_files(a: str, b: str) -> bool:
    """Byte-equal, compared in READ_BYTES reads."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(READ_BYTES), fb.read(READ_BYTES)
            if x != y:
                return False
            if not x:
                return True


def sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(READ_BYTES):
            h.update(block)
    return h.hexdigest()


def _timed(fn, device: torch.device):
    """(fn's result, host seconds, peak device bytes or None, launches):
    fn ends in a synchronisation; the peak counts from its start."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return out, seconds, peak, probes.launches_since(before, "")


def run(src: str, segment_size: int = api.DEFAULT_SEGMENT_SIZE,
        device=None, dst: str | None = None) -> dict:
    """`src` through compress_file (Markov, as the reference's script)
    into `dst` (default: the temporary
    directory's mhc_multigb.mhc, kept) and back through decompress_file
    (`dst` + ".out", removed after the comparison), on `device` (None:
    the first CUDA card; raises without one): the JSON line's dict."""
    device = resolve_device(device)
    dst = dst or os.path.join(tempfile.gettempdir(), "mhc_multigb.mhc")
    back = dst + ".out"
    n_bytes = os.path.getsize(src)
    # the card's context and the kernel libraries, outside the timings
    api.decompress(api.compress(b"warm-up " * 128, device=device),
                   device=device)
    base = rss_bytes()
    with PeakRss() as rss:
        stats, enc_s, enc_peak, enc_launches = _timed(
            lambda: api.compress_file(src, dst, segment_size=segment_size,
                                      device=device), device)
        dstats, dec_s, dec_peak, dec_launches = _timed(
            lambda: api.decompress_file(dst, back, device=device), device)
        ok = dstats["orig_bytes"] == n_bytes and same_files(src, back)
    os.remove(back)
    n_seg = stats["n_segments"]
    return {
        "bytes": n_bytes,
        "segment_mb": segment_size / (1 << 20),
        "n_segments": n_seg,
        "ratio": stats["ratio"],
        "encode_s": enc_s,
        "decode_s": dec_s,
        "encode_MBps": n_bytes / enc_s / 1e6,
        "decode_MBps": n_bytes / dec_s / 1e6,
        "roundtrip_ok": ok,
        "peak_rss_GB": rss.peak / 1e9,
        "rss_base_GB": None if base is None else base / 1e9,
        "peak_rss_over_base_GB": (None if base is None
                                  else (rss.peak - base) / 1e9),
        **probes.device_fields(device),
        "peak_device_bytes": {"compress": enc_peak,
                              "decompress": dec_peak},
        "table_builder": ("device (code_tables: K11 + K13, one launch)"
                          if device.type == "cuda" else
                          "native C++" if native.available() else "numpy"),
        "encode_s_per_segment": enc_s / n_seg,
        "decode_s_per_segment": dec_s / n_seg,
        "compressed_bytes": stats["compressed_bytes"],
        "sha256": sha256_of(dst),
        "launches": {"compress": enc_launches, "decompress": dec_launches},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("gb", nargs="?", type=float, default=2.0,
                   help="GB of the default input (ignored with --input)")
    p.add_argument("segment_mb", nargs="?", type=int,
                   default=api.DEFAULT_SEGMENT_SIZE >> 20,
                   help="segment size in MB (default 1024)")
    p.add_argument("--input", default=None,
                   help="an existing file to stream instead")
    p.add_argument("--device", default=None,
                   help="cuda:N (default: the first card; exit 1 without "
                        "one) or cpu (the plain versions)")
    args = p.parse_args(argv)
    if args.segment_mb < 1:
        p.error(f"segment_MB {args.segment_mb} must be 1 or more")
    device = probes.resolve("multigb", args.device)
    src = args.input or default_input(args.gb)
    res = run(src, args.segment_mb << 20, device)
    print(json.dumps(res), flush=True)
    return 0 if res["roundtrip_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
