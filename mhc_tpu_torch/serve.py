"""Long-running codec service.

Counterpart of `mhc_tpu/serve.py`: a process that pays torch start-up
and the kernel builds once, then serves compress / decompress over HTTP
with the kernels loaded (the CLI pays start-up on every call).

    python -m mhc_tpu_torch.serve --port 8750 &              # the first CUDA card
    python -m mhc_tpu_torch.serve --port 0 --device cuda:1   # any free port
    python -m mhc_tpu_torch.serve --device cpu               # the plain versions
    curl -s --data-binary @file http://127.0.0.1:8750/compress?mode=markov > file.mhc
    curl -s --data-binary @file.mhc http://127.0.0.1:8750/decompress > file.out
    curl -s http://127.0.0.1:8750/stats

POST /compress?mode=&block_size= and /decompress reply with the body and
the headers X-MHC-Seconds (the request's codec time, its wait for the
device included) and X-MHC-MBps (the uncompressed side over that time);
a ValueError (a bad mode, block size or container) is a 400, an unknown
path a 404. GET /stats and /healthz. `--device` defaults to the first
CUDA card; without one `main` raises before it warms up or binds, and
the CPU serves only when `--device cpu` names it. The warm-up builds the
kernels, so a build failure ends `main`. SIGINT stops the server (exit
0). `main` prints the bound address after `listening on`.

Device work is serialised by one lock per server; request handling and
IO overlap in threads. Differences from the reference:
- the counters of /stats are updated under a lock of their own (the
  reference counts requests and bytes outside any lock, so concurrent
  requests can lose updates);
- `?method=` is accepted and not read: the reference's decode methods
  are TPU variants that write the same bytes, and the port has one;
- device work runs under the lock inside `torch.cuda.device(device)`,
  so that a handler thread's current device is the served card;
- the device, its lock and the counters are attributes of the server
  (`make_server`), not module state, so that one process can hold
  several servers;
- the listen backlog is 128 connections, not socketserver's 5, past
  which clients that connect at once are reset.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
import time
from contextlib import nullcontext
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from . import api
from .config import resolve_device


class Stats:
    """The counters of /stats, each update under one lock."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.started = time.time()
        self.requests = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.errors = 0
        self.codec_seconds = 0.0
        self.codec_bytes = 0

    def add(self, **deltas) -> None:
        with self.lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def report(self) -> dict:
        with self.lock:
            return {
                "uptime_s": round(time.time() - self.started, 1),
                "requests": self.requests,
                "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
                "errors": self.errors,
                "codec_seconds": round(self.codec_seconds, 3),
                "codec_MBps": round(
                    self.codec_bytes / self.codec_seconds / 1e6, 2)
                if self.codec_seconds else None,
            }


def _on(device: torch.device):
    """The current-device context of a CUDA device (nothing for the
    CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else nullcontext()


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet
        pass

    def _reply(self, code: int, body: bytes,
               ctype: str = "application/octet-stream", headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/stats":
            self._reply(200, json.dumps(self.server.stats.report()).encode(),
                        "application/json")
        elif path == "/healthz":
            self._reply(200, b"ok", "text/plain")
        else:
            self._reply(404, b"not found", "text/plain")

    def _codec(self, fn, data: bytes, **kw) -> bytes:
        srv = self.server
        with srv.device_lock, _on(srv.device):
            return fn(data, device=srv.device, **kw)

    def do_POST(self):
        url = urlparse(self.path)
        q = parse_qs(url.query)
        n = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(n)
        stats = self.server.stats
        stats.add(requests=1, bytes_in=len(data))
        t0 = time.perf_counter()
        try:
            if url.path == "/compress":
                mode = q.get("mode", ["markov"])[0]
                block_size = int(q.get("block_size",
                                       [api.DEFAULT_BLOCK_SIZE])[0])
                out = self._codec(api.compress, data, mode=mode,
                                  block_size=block_size)
            elif url.path == "/decompress":
                out = self._codec(api.decompress, data)
            else:
                self._reply(404, b"not found", "text/plain")
                return
        except ValueError as e:
            stats.add(errors=1)
            self._reply(400, str(e).encode(), "text/plain")
            return
        dt = time.perf_counter() - t0
        codec_bytes = max(len(data), len(out))  # uncompressed side
        stats.add(bytes_out=len(out), codec_seconds=dt,
                  codec_bytes=codec_bytes)
        self._reply(200, out, headers=(
            ("X-MHC-Seconds", f"{dt:.4f}"),
            ("X-MHC-MBps", f"{codec_bytes / dt / 1e6:.2f}")))


class Server(ThreadingHTTPServer):
    """A ThreadingHTTPServer that queues 128 connections, not 5."""
    request_queue_size = 128


def make_server(host: str, port: int, device=None) -> ThreadingHTTPServer:
    """A bound server (port 0: any free port, `server_port` tells which)
    that codes on `device` (None: the first CUDA card; raises without
    one). Serve it with `serve_forever()`."""
    dev = resolve_device(device)
    srv = Server((host, port), Handler)
    srv.device = dev
    srv.device_lock = threading.Lock()
    srv.stats = Stats()
    return srv


def warmup(block_size: int = api.DEFAULT_BLOCK_SIZE, device=None) -> None:
    """Run both modes once on `device` before accepting traffic: builds
    and loads the kernels."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    seed_data = rng.integers(0, 64, 4 * block_size, dtype=np.uint8).tobytes()
    with _on(dev):
        for mode in ("markov", "huffman"):
            api.decompress(api.compress(seed_data, mode=mode,
                                        block_size=block_size, device=dev),
                           device=dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mhc-serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8750)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--device", default=None,
                   help="default: the first CUDA card; cpu names the CPU")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if not args.no_warmup:
        t0 = time.time()
        warmup(device=dev)
        print(f"warmup done in {time.time() - t0:.1f}s", flush=True)
    srv = make_server(args.host, args.port, dev)
    host, port = srv.server_address[:2]
    print(f"mhc-serve listening on {host}:{port}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    # a shell ignores SIGINT in the background jobs it starts; the server
    # stops on SIGINT all the same
    signal.signal(signal.SIGINT, signal.default_int_handler)
    raise SystemExit(main())
