"""Header-mutation sweep of the port's decode routes (F5's class: a
container field that sizes or steers work before anything bounds it).

Each base container (small `tests.corpus` inputs under fixed seeds: Markov
and order-0, each in the substream layout, whose payload is word-aligned
for Markov and byte-aligned for order-0, and in the legacy layout, crc on;
and an order-0 substream base with crc off) is mutated:

- each header byte 4-23 set to each of BYTE_VALUES;
- `orig_len`, `block_size` and `n_blocks` rewritten as whole fields to
  0, 1, 3, the base's value +- 1, 2**20, 2**31, 2**32 - 1, and, for
  `orig_len`, 2**40 and 2**63.

The contract, for every blob on every route: the original bytes or a
ValueError; never another exception, never other bytes, never a call that
runs long. Where the mutated header carries no crc, nothing can tell
rewritten bytes from the original (an `orig_len` one byte shorter decodes
to a prefix; a unit index read at another unit count gives other unit
streams, which the host codec and K7 decode alike only where they are
prefix codes), so there the route may also return other bytes, of the
length the header claims. `api.decompress` and
`hybrid.decompress` at 0.5 take every blob; `hybrid` at 0 and 1,
`decompress_file`, the CLI's `decode` (in-process, exit 1 with
decompress_file's message) and `decompress_sharded` on a world of one
take the blobs that parse.

F5's own containers (`chip_smoke.f5_containers`: du_log2 40, 63, 64 and
200; a legacy block size of 0, of 2**31 and of 2**32 - 1) go through every
route with the decoders patched to fail: (a) and (b) are refused before
any decode or expansion; (d) decodes, in rows of the short block's own
length. `serve` answers (a), (b) and the writer's `block_size=2**32` with
400 and counts them in /stats.
"""

import functools
import struct
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import chip_smoke
from mhc_tpu_torch import api, container, engine, hybrid, serve
from mhc_tpu_torch.cli import main as cli_main
from mhc_tpu_torch.ops.kernels import decode_cuda, stages_cuda
from mhc_tpu_torch.parallel import pipeline
from mhc_tpu_torch.utils import native
from tests.corpus import english_like, mixed_binary

BYTE_VALUES = (0, 1, 2, 3, 15, 16, 31, 32, 33, 40, 63, 64, 128, 200, 255)
# a call runs in milliseconds on these sizes; a header claim that sized
# work by itself would run for minutes or exhaust memory
CALL_SECONDS = 5.0

BASES = {
    # name: (input, compress arguments); units of 8 bytes keep the CPU's
    # plain decode (a torch step a symbol) short
    "markov_substreams": (english_like(300, seed=161),
                          dict(mode="markov", block_size=32,
                               decode_unit=8)),
    "order0_substreams": (mixed_binary(300, seed=162),
                          dict(mode="huffman", block_size=32,
                               decode_unit=8)),
    "markov_legacy": (english_like(100, seed=163),
                      dict(mode="markov", block_size=8, decode_unit=8)),
    "order0_legacy": (mixed_binary(300, seed=164),
                      dict(mode="huffman", block_size=8, decode_unit=8)),
    "order0_substreams_no_crc": (mixed_binary(300, seed=165),
                                 dict(mode="huffman", block_size=32,
                                      decode_unit=8, crc=False)),
}

# (offset, struct format, extra values) of the whole fields
FIELDS = {"orig_len": (8, "<Q", (1 << 40, 1 << 63)),
          "block_size": (16, "<I", ()),
          "n_blocks": (20, "<I", ())}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The sweep is thousands of small torch calls: a pool of threads per
    test worker spins against the other workers' pools (as in
    test_torch_param_grid.py), so the file runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def base_blob(name: str) -> bytes:
    data, kw = BASES[name]
    return api.compress(data, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def mutations(name: str) -> tuple:
    """((label, blob), ...) of the base's mutations, each blob once and
    none the base itself."""
    blob = base_blob(name)
    meta = container.parse_container(blob)
    out = {}
    for i in range(4, 24):
        for v in BYTE_VALUES:
            out.setdefault(chip_smoke.with_field(blob, i, "<B", v),
                           f"byte{i}={v}")
    for field, (off, fmt, extra) in FIELDS.items():
        base = getattr(meta, field)
        for v in (0, 1, 3, base - 1, base + 1, 1 << 20, 1 << 31,
                  (1 << 32) - 1, *extra):
            out.setdefault(chip_smoke.with_field(blob, off, fmt, v),
                           f"{field}={v}")
    out.pop(blob, None)
    return tuple((label, b) for b, label in out.items())


def parses(blob: bytes) -> bool:
    try:
        container.parse_container(blob)
    except ValueError:
        return False
    return True


def outcome(route, blob: bytes, label: str):
    """The route's bytes, or the ValueError it raised; any other exception
    or a long call fails the test."""
    t0 = time.perf_counter()
    try:
        out = route(blob)
    except ValueError as e:
        out = e
    except Exception as e:  # noqa: BLE001
        raise AssertionError(f"{label}: {type(e).__name__} escaped: "
                             f"{e}") from e
    dt = time.perf_counter() - t0
    assert dt < CALL_SECONDS, f"{label}: the call took {dt:.1f} s"
    return out


@functools.lru_cache(maxsize=None)
def api_outcome(blob: bytes):
    return outcome(lambda b: api.decompress(b, device="cpu"), blob, "api")


def check(name: str, label: str, blob: bytes, out) -> None:
    if isinstance(out, ValueError) or out == BASES[name][0]:
        return
    assert not blob[6] & container.FLAG_CRC32, (
        f"{name} {label}: other bytes ({len(out)})")
    # no crc: the bytes the header claims, whatever they hold
    claimed = struct.unpack_from("<Q", blob, 8)[0]
    assert len(out) == claimed, f"{name} {label}: {len(out)} bytes"


# ---------------------------------------------------------------------------
# The routes (each: blob -> bytes, or raise).
# ---------------------------------------------------------------------------

def _hybrid(frac):
    return lambda b: hybrid.decompress(b, host_fraction=frac, device="cpu")


def _files(tmp_path):
    src, dst = tmp_path / "in.mhc", tmp_path / "out.bin"

    def run(b):
        src.write_bytes(b)
        api.decompress_file(str(src), str(dst), device="cpu")
        return dst.read_bytes()
    return run


def _cli(tmp_path, capsys):
    """The CLI's decode in-process: exit 0 and the file, or exit 1 whose
    message must be decompress_file's ValueError (re-raised here)."""
    src, dst = tmp_path / "in.mhc", tmp_path / "out.bin"
    files = _files(tmp_path / "files")

    def run(b):
        src.write_bytes(b)
        rc = cli_main(["decode", "--device", "cpu", str(src), str(dst)])
        err = capsys.readouterr().err
        if rc == 0:
            return dst.read_bytes()
        assert rc == 1, rc
        try:
            files(b)
        except ValueError as e:
            assert err.strip() == f"mhc: error: {e}", err
            raise
        raise AssertionError(f"the CLI failed ({err.strip()}) where "
                             "decompress_file decodes")
    return run


def _sharded(b):
    return pipeline.decompress_sharded(b, device="cpu")


EVERY_BLOB = ("api", "hybrid_half")
PARSED_BLOBS = ("hybrid_device", "hybrid_host", "files", "cli", "sharded")


@pytest.fixture
def routes(tmp_path, capsys):
    (tmp_path / "files").mkdir()
    return {"api": lambda b: api.decompress(b, device="cpu"),
            "hybrid_half": _hybrid(0.5), "hybrid_device": _hybrid(0.0),
            "hybrid_host": _hybrid(1.0), "files": _files(tmp_path),
            "cli": _cli(tmp_path, capsys), "sharded": _sharded}


@pytest.mark.parametrize("route", EVERY_BLOB + PARSED_BLOBS)
@pytest.mark.parametrize("name", list(BASES))
def test_header_sweep(name, route, routes):
    """Every mutation of the base through the route: the original bytes
    or ValueError (with no crc in the header, also other bytes of the
    claimed length). The routes of PARSED_BLOBS take the blobs that
    parse."""
    fn = routes[route]
    assert fn(base_blob(name)) == BASES[name][0]
    tried = 0
    for label, blob in mutations(name):
        if route in PARSED_BLOBS and not parses(blob):
            continue
        out = (api_outcome(blob) if route == "api"
               else outcome(fn, blob, f"{name} {label}"))
        check(name, label, blob, out)
        tried += 1
    assert tried >= 100


def test_sweep_covers_both_outcomes():
    """The sweep is not vacuous: on each base some mutations decode and
    some are refused, after the parse as well as in it."""
    for name in BASES:
        seen = {"decoded": 0, "refused_after_parse": 0,
                "refused_in_parse": 0}
        for label, blob in mutations(name):
            out = api_outcome(blob)
            if not isinstance(out, ValueError):
                seen["decoded"] += 1
            elif parses(blob):
                seen["refused_after_parse"] += 1
            else:
                seen["refused_in_parse"] += 1
        assert min(seen.values()) > 0, (name, seen)


def test_orig_len_zero_still_meets_the_crc():
    """An orig_len rewritten to 0 used to decode to b"" without the crc
    check; the trailer of the original bytes now refuses it, while a real
    empty container still decodes."""
    blob = chip_smoke.with_field(base_blob("markov_substreams"), 8, "<Q", 0)
    for route in (lambda b: api.decompress(b, device="cpu"), _hybrid(0.5),
                  _sharded):
        with pytest.raises(ValueError, match="crc32"):
            route(blob)
        assert route(api.compress(b"", device="cpu")) == b""
    assert api.decompress(blob, verify=False, device="cpu") == b""


@pytest.mark.parametrize("orig_len", [1 << 32, 1 << 40, 1 << 63])
def test_head_parse_bounds_the_unit_count(tmp_path, orig_len):
    """decompress_file parses each segment's head alone; an orig_len over
    an index of no residual bits (3 bytes for any unit count) made that
    parse allocate a length per claimed unit (128 GiB at 2**40). The
    rest of the file now bounds the count as the blob's length does."""
    bad = chip_smoke.with_index(base_blob("markov_substreams"),
                                struct.pack("<HB", 1, 0), payload=b"",
                                orig_len=orig_len)
    src = tmp_path / "in.mhc"
    src.write_bytes(bad)
    with pytest.raises(ValueError, match="truncated container"):
        api.decompress_file(str(src), str(tmp_path / "out"), device="cpu")
    with pytest.raises(ValueError, match="unit index"):
        container.parse_container(bad, head_only=True, avail=len(bad))


# ---------------------------------------------------------------------------
# F5's containers, on every route, with the decoders patched to fail.
# ---------------------------------------------------------------------------

F5 = chip_smoke.f5_containers()
F5_REFUSED = [k for k, (_, want) in F5.items() if want is not None]
F5_DECODED = [k for k, (_, want) in F5.items() if want is None]


@pytest.fixture
def no_sizing(monkeypatch):
    """Fails the test if a decode or an expansion is called."""
    def fail(*args, **kwargs):
        raise AssertionError("a decode or expansion was called")
    for mod, fn in ((engine, "decode"), (engine, "_decode_inputs"),
                    (decode_cuda, "decode_units"),
                    (stages_cuda, "expand_units"),
                    (native, "decode_units")):
        monkeypatch.setattr(mod, fn, fail)


@pytest.mark.parametrize("route", EVERY_BLOB + PARSED_BLOBS)
@pytest.mark.parametrize("case", F5_REFUSED)
def test_f5_refused_before_sizing(case, route, routes, no_sizing):
    bad, want = F5[case]
    with pytest.raises(ValueError, match=f"corrupt container \\({want}\\)"):
        routes[route](bad)


@pytest.mark.parametrize("route", EVERY_BLOB + PARSED_BLOBS)
@pytest.mark.parametrize("case", F5_DECODED)
def test_f5_legacy_block_size_decodes_in_short_rows(case, route, routes,
                                                    monkeypatch):
    """A legacy container's one 520-byte block under a header block size
    of 2**31 or 2**32 - 1 decodes to its bytes; K7 (its plain version
    here) is launched at n_out 528, the block rounded up to 16 bytes, not
    at the block size."""
    widths = []
    real = decode_cuda.decode_units

    def spy(*args, n_out, **kwargs):
        widths.append(n_out)
        return real(*args, n_out=n_out, **kwargs)
    monkeypatch.setattr(decode_cuda, "decode_units", spy)
    assert routes[route](F5[case][0]) == chip_smoke.F5_TEXT
    assert set(widths) <= {528}
    if route in ("api", "hybrid_device", "files", "cli", "sharded"):
        assert widths == [528]


def test_f5_served_errors_are_400_and_counted():
    """(a) and (b) posted to /decompress and `block_size` 0 and 2**32 to
    /compress are each answered 400 and counted in /stats; (d) decodes."""
    srv = serve.make_server("127.0.0.1", 0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_port}"

    def post(path, body):
        req = urllib.request.Request(url + path, data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
    try:
        bad = [("/decompress", F5[k][0]) for k in F5_REFUSED]
        bad += [(f"/compress?block_size={v}", b"abcabc" * 10)
                for v in (0, 1 << 32)]
        for path, body in bad:
            status, reply = post(path, body)
            assert status == 400, (path, status, reply)
            assert b"corrupt container" in reply or b"block_size" in reply
        for k in F5_DECODED:
            assert post("/decompress", F5[k][0]) == (200,
                                                     chip_smoke.F5_TEXT)
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = r.read()
        assert srv.stats.errors == len(bad), stats
        assert srv.stats.requests == len(bad) + len(F5_DECODED)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
