"""The port's codec service (mhc_tpu_torch.serve) on the CPU, against the
JAX package: the counterpart of tests/test_serve.py. An in-process server
on device="cpu"; the bodies of /compress are mhc_tpu.api.compress's
bytes, and each package decodes the other's containers (tolerance 0, an
integer codec)."""

import json
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from mhc_tpu import api as jax_api
from mhc_tpu_torch import serve
from tests.corpus import english_like, mixed_binary

DATA = english_like(50_000, seed=55)


def _start(device="cpu"):
    srv = serve.make_server("127.0.0.1", 0, device=device)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_port}"


def _stop(srv, t):
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def server():
    srv, t, url = _start()
    yield url
    _stop(srv, t)


def _post(url, data, headers=False):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read()
        return (body, r.headers) if headers else body


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def _status(url, data) -> int:
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, data)
    return ei.value.code


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_http_compress_is_the_reference_container(server, mode):
    blob = _post(server + f"/compress?mode={mode}&block_size=4096", DATA)
    assert blob == jax_api.compress(DATA, mode=mode, block_size=4096)
    assert _post(server + "/decompress", blob) == DATA
    # the JAX package reads the served container
    assert jax_api.decompress(blob) == DATA


@pytest.mark.parametrize("mode", ["markov", "huffman"])
def test_http_decompresses_the_reference_container(server, mode):
    data = mixed_binary(40_000, seed=3)
    assert _post(server + "/decompress",
                 jax_api.compress(data, mode=mode)) == data


def test_http_default_mode_round_trip(server):
    data = english_like(30_000, seed=56)
    blob = _post(server + "/compress", data)
    assert blob == jax_api.compress(data)
    assert _post(server + "/decompress?method=pallas", blob) == data


@pytest.mark.parametrize("path,body", [
    ("/decompress", b"not a container"),
    ("/compress?mode=lz77", DATA),
    ("/compress?block_size=3000", DATA),
    ("/compress?block_size=abc", DATA),
    ("/compress?block_size=0", DATA),
])
def test_http_bad_input_is_400(server, path, body):
    assert _status(server + path, body) == 400


def test_http_unknown_path_is_404(server):
    assert _status(server + "/nope", b"x") == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server + "/nope")
    assert ei.value.code == 404


def test_stats_health_and_rate_headers(server):
    assert _get(server + "/healthz") == b"ok"
    data = english_like(30_000, seed=57)
    blob, h = _post(server + "/compress?block_size=4096", data, headers=True)
    assert float(h["X-MHC-Seconds"]) > 0 and float(h["X-MHC-MBps"]) > 0
    back, h = _post(server + "/decompress", blob, headers=True)
    assert back == data
    assert float(h["X-MHC-Seconds"]) > 0 and float(h["X-MHC-MBps"]) > 0
    st = json.loads(_get(server + "/stats"))
    assert set(st) == {"uptime_s", "requests", "bytes_in", "bytes_out",
                       "errors", "codec_seconds", "codec_MBps"}
    assert st["requests"] >= 2 and st["codec_seconds"] > 0
    assert st["codec_MBps"] > 0 and st["bytes_out"] >= len(data)


def test_concurrent_requests_and_exact_stats():
    """Eight concurrent clients (4 Markov, 4 order-0) on a fresh server,
    each reply the reference container; then 128 requests that fail from
    32 threads with a short switch interval: /stats counts every one."""
    srv, t, url = _start()
    try:
        inputs = [english_like(20_000, seed=60 + i) for i in range(8)]
        modes = ["markov", "huffman"] * 4
        with ThreadPoolExecutor(8) as pool:
            blobs = list(pool.map(
                lambda dm: _post(url + f"/compress?mode={dm[1]}", dm[0]),
                zip(inputs, modes)))
        for d, m, b in zip(inputs, modes, blobs):
            assert b == jax_api.compress(d, mode=m)
        st = json.loads(_get(url + "/stats"))
        assert st["requests"] == 8 and st["errors"] == 0
        assert st["bytes_in"] == sum(map(len, inputs))
        assert st["bytes_out"] == sum(map(len, blobs))

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with ThreadPoolExecutor(32) as pool:
                codes = list(pool.map(
                    lambda _: _status(url + "/decompress", b"junk"),
                    range(128)))
        finally:
            sys.setswitchinterval(old)
        assert codes == [400] * 128
        st = json.loads(_get(url + "/stats"))
        assert st["requests"] == 8 + 128 and st["errors"] == 128
    finally:
        _stop(srv, t)


def test_main_without_a_card_raises_before_binding(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_bind(*a, **k):
        raise AssertionError("main bound a socket")

    monkeypatch.setattr(serve, "Server", no_bind)
    monkeypatch.setattr(serve, "warmup", no_bind)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--port", "0", "--no-warmup"])
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--port", "0"])


def test_warmup_on_the_cpu():
    serve.warmup(block_size=4096, device="cpu")
