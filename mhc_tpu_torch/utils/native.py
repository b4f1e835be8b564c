"""ctypes binding for the repo's native host runtime (native/*.cpp).

The port's own binding to the C++ library that `mhc_tpu` also uses: the
deterministic Huffman length builder and the container's metadata
decoders, which keep a numpy fallback, so the codec also works where no
C++ compiler is installed; and the threaded host unit codec of the
hybrid executor (`join_rows` to `decode_units`), which has none and
raises without the library: a caller that asks for host threads gets
them or an error.

The port compiles `native/mhc_host.cpp` and `native/mhc_codec.cpp` with
the flags of `native/Makefile` into its own library under
`build/mhc_tpu_torch/`, and never writes into `native/`. The build goes
to a per-process temporary file that `os.replace` puts in place, so a
loader in another process sees either no library or a whole one. It is
rebuilt when it is older than either source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO, "native")
SOURCES = tuple(os.path.join(_NATIVE, f)
                for f in ("mhc_host.cpp", "mhc_codec.cpp"))
# native/Makefile's CXXFLAGS and its -shared
CXXFLAGS = ["-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread",
            "-shared"]
BUILD_DIR = os.path.join(_REPO, "build", "mhc_tpu_torch")
LIB_NAME = "libmhc_host.so"

_HOST_VERSION = 2   # mhc_version()
_CODEC_VERSION = 5  # mhc_codec_version()

_lib = None
_tried = False


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile the host library into `build_dir` unless it is there and
    newer than both sources; returns its path. Raises RuntimeError with
    the compiler's output when the build fails."""
    so = os.path.join(build_dir, LIB_NAME)
    if (os.path.exists(so) and os.path.getmtime(so)
            >= max(map(os.path.getmtime, SOURCES))):
        return so
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(["g++", *CXXFLAGS, "-o", tmp, *SOURCES],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build {so}: {e}") from e
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed to build {so} (exit {r.returncode})"
                           f":\n{r.stderr}")
    os.replace(tmp, so)
    return so


def load(build_dir: str = BUILD_DIR):
    """The host library of `build_dir`, built if stale, typed; None when
    it cannot be built or loaded or its versions are not the port's."""
    try:
        lib = ctypes.CDLL(build(build_dir))
    except (OSError, RuntimeError):
        return None
    lib.mhc_split.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.mhc_split.restype = None
    lib.mhc_join.argtypes = lib.mhc_split.argtypes
    lib.mhc_join.restype = None
    lib.mhc_hist_markov.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.mhc_hist_order0.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.mhc_build_enc_table.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.mhc_build_dec_lut.argtypes = lib.mhc_build_enc_table.argtypes
    lib.mhc_encode_units.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int]
    lib.mhc_decode_units.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]
    for fn in (lib.mhc_hist_markov, lib.mhc_hist_order0,
               lib.mhc_build_enc_table, lib.mhc_build_dec_lut,
               lib.mhc_encode_units, lib.mhc_decode_units):
        fn.restype = None
    lib.mhc_code_lengths.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
    lib.mhc_code_lengths.restype = None
    lib.mhc_entropy_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.mhc_entropy_decode.restype = ctypes.c_int64
    lib.mhc_codec_version.restype = ctypes.c_int
    lib.mhc_version.restype = ctypes.c_int
    if (lib.mhc_version() == _HOST_VERSION
            and lib.mhc_codec_version() == _CODEC_VERSION):
        return lib
    return None


def _load():
    global _lib, _tried
    if not _tried:
        _tried = True
        _lib = load()
    return _lib


def available() -> bool:
    return _load() is not None


def code_lengths(scaled_counts: np.ndarray, max_len: int) -> np.ndarray:
    """Huffman code lengths for (..., 256) pre-rescaled counts, bit-identical
    to `ops.huffman.code_lengths_np`, which it falls back to without the
    library."""
    counts = np.ascontiguousarray(scaled_counts, dtype=np.int32)
    flat = counts.reshape(-1, 256)
    lib = _load()
    if lib is None:
        from ..ops import huffman
        rows = [huffman.code_lengths_np(row, max_len) for row in flat]
        return np.stack(rows).reshape(counts.shape).astype(np.uint8)
    out = np.empty(flat.shape, dtype=np.uint8)
    lib.mhc_code_lengths(flat.ctypes.data, flat.shape[0], max_len,
                         out.ctypes.data)
    return out.reshape(counts.shape)


def check_code_lengths(lengths) -> None:
    """Raises ValueError unless every row (last axis) of `lengths` is a
    prefix code: no length over 15 and a Kraft sum of at most one, sum
    over nonzero l of 2**(15 - l) <= 2**15. An incomplete set is legal (a
    one-symbol row has length 1). The native table builders fill each
    code's 2**(15 - l) entries of a 2**15-entry table, so an over-full
    set read from a container would write past it."""
    from ..ops.huffman import MAX_CODE_LEN
    lens = np.asarray(lengths, dtype=np.int64)
    if lens.size == 0:
        return
    if int(lens.max()) > MAX_CODE_LEN:
        raise ValueError("mhc: corrupt container (code lengths)")
    kraft = np.where(lens > 0, 1 << (MAX_CODE_LEN - lens), 0).sum(axis=-1)
    if int(np.max(kraft)) > 1 << MAX_CODE_LEN:
        raise ValueError("mhc: corrupt container (code lengths)")


def entropy_decode(coded: bytes, lengths: np.ndarray, n_out: int):
    """Decode n_out symbols of a canonical order-0 stream (container
    metadata sections). Returns (symbols uint8, bytes_consumed). Raises
    ValueError where `lengths` is no prefix code (check_code_lengths)."""
    check_code_lengths(lengths)
    lens = np.ascontiguousarray(lengths, dtype=np.uint8)
    A = lens.shape[0]
    src = np.frombuffer(coded, dtype=np.uint8)
    out = np.empty(n_out, dtype=np.uint8)
    if n_out == 0:
        return out, 0
    lib = _load()
    if lib is not None:
        used = lib.mhc_entropy_decode(src.ctypes.data, src.size,
                                      lens.ctypes.data, A, n_out,
                                      out.ctypes.data)
        if used < 0:
            raise ValueError("mhc: corrupt entropy-coded section")
        return out, int(used)
    return _entropy_decode_py(src, lens, n_out, out)


def _entropy_decode_py(src, lens, n_out, out):
    """Canonical decode through a 15-bit lookup table, in Python."""
    from ..ops.canonical import canonical_codes_host
    full = np.zeros(256, np.int64)
    full[:lens.shape[0]] = lens
    codes = canonical_codes_host(full)["codes"].astype(np.int64)
    lut_sym = np.zeros(1 << 15, np.uint8)
    lut_len = np.zeros(1 << 15, np.uint8)
    for s in range(lens.shape[0]):
        if full[s] == 0:
            continue
        a = int(codes[s]) << (15 - int(full[s]))
        b = (int(codes[s]) + 1) << (15 - int(full[s]))
        lut_sym[a:b] = s
        lut_len[a:b] = full[s]
    mask64 = (1 << 64) - 1
    acc = nbits = pos = bits_used = 0
    nb = src.size
    for i in range(n_out):
        while nbits <= 56:
            byte = int(src[pos]) if pos < nb else 0
            acc = (acc | byte << (56 - nbits)) & mask64
            pos += 1
            nbits += 8
        w = acc >> (64 - 15)
        ln = int(lut_len[w])
        if ln == 0:
            raise ValueError("mhc: corrupt entropy-coded section")
        out[i] = lut_sym[w]
        acc = (acc << ln) & mask64
        nbits -= ln
        bits_used += ln
    return out, (bits_used + 7) // 8


def split_rows(payload, lens: np.ndarray, stride: int) -> np.ndarray:
    """Packed payload + per-row lengths -> (R, stride) uint8 zero-padded
    rows."""
    buf = np.frombuffer(payload, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    R = lens.shape[0]
    offsets = np.zeros(R, dtype=np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    rows = np.zeros((R, stride), dtype=np.uint8)
    lib = _load()
    if lib is None:
        mask = np.arange(stride)[None, :] < lens[:, None]
        rows[mask] = buf[: int(lens.sum())]
        return rows
    lib.mhc_split(buf.ctypes.data, R, stride, lens.ctypes.data,
                  offsets.ctypes.data, rows.ctypes.data)
    return rows


# ---------------------------------------------------------------------------
# The host unit codec (native/mhc_codec.cpp, threaded): bit-identical to
# the device path by construction, so the hybrid executor may give any
# unit to either. No fallbacks.
# ---------------------------------------------------------------------------

def require():
    """The loaded library; raises RuntimeError without it."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "the native host library "
            f"({os.path.join(BUILD_DIR, LIB_NAME)}) failed to build or "
            "load")
    return lib


def join_rows(rows: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate per-row prefixes: rows (R, S) uint8, lens (R,) ->
    packed bytes of sum(lens)."""
    lib = require()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    R, S = rows.shape
    if R and (lens.min() < 0 or lens.max() > S):
        raise ValueError("join_rows: a length exceeds the row")
    offsets = np.zeros(R, dtype=np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    out = np.empty(int(lens.sum()), dtype=np.uint8)
    lib.mhc_join(rows.ctypes.data, R, S, lens.ctypes.data,
                 offsets.ctypes.data, out.ctypes.data)
    return out.tobytes()


def hist_markov(data: np.ndarray, unit: int) -> np.ndarray:
    """(256, 256) int64 Markov histogram, the context reset per unit."""
    lib = require()
    d = np.ascontiguousarray(data, dtype=np.uint8)
    counts = np.zeros(256 * 256, np.int64)
    lib.mhc_hist_markov(d.ctypes.data, d.size, unit, counts.ctypes.data)
    return counts.reshape(256, 256)


def hist_order0(data: np.ndarray) -> np.ndarray:
    """(256,) int64 byte histogram."""
    lib = require()
    d = np.ascontiguousarray(data, dtype=np.uint8)
    counts = np.zeros(256, np.int64)
    lib.mhc_hist_order0(d.ctypes.data, d.size, counts.ctypes.data)
    return counts


def build_enc_table(lengths: np.ndarray) -> np.ndarray:
    """(nctx, 256) lengths -> (nctx, 256) uint32 len << 16 | code."""
    lib = require()
    lens = np.ascontiguousarray(lengths, dtype=np.uint8).reshape(-1, 256)
    packed = np.empty(lens.shape, np.uint32)
    lib.mhc_build_enc_table(lens.ctypes.data, lens.shape[0],
                            packed.ctypes.data)
    return packed


def encode_units(data: np.ndarray, unit: int, packed: np.ndarray,
                 markov: bool, row_stride: int, raw_mode: int = 0):
    """Encode the ceil(n / unit) unit streams of `data` into rows of
    `row_stride` bytes; returns (rows, bit_lens). raw_mode: 0 no literal
    units, 1 the unaligned layout's rule, 2 the word-aligned rule
    (container FLAG_RAW_UNITS)."""
    lib = require()
    d = np.ascontiguousarray(data, dtype=np.uint8)
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n_units = (d.size + unit - 1) // unit
    rows = np.empty((n_units, row_stride), np.uint8)
    bit_lens = np.empty(n_units, np.int64)
    lib.mhc_encode_units(d.ctypes.data, d.size, unit, n_units,
                         packed.ctypes.data, 1 if markov else 0,
                         rows.ctypes.data, row_stride, bit_lens.ctypes.data,
                         raw_mode)
    return rows, bit_lens


def build_dec_lut(lengths: np.ndarray) -> np.ndarray:
    """(nctx, 256) lengths -> (nctx, 2**15) uint16 LUT (sym | len << 8).
    Raises ValueError where a row is no prefix code
    (check_code_lengths)."""
    lib = require()
    check_code_lengths(lengths)
    lens = np.ascontiguousarray(lengths, dtype=np.uint8).reshape(-1, 256)
    lut = np.empty((lens.shape[0], 1 << 15), np.uint16)
    lib.mhc_build_dec_lut(lens.ctypes.data, lens.shape[0], lut.ctypes.data)
    return lut


def decode_units(payload: np.ndarray, offsets: np.ndarray,
                 byte_lens: np.ndarray, unit: int, n_total: int,
                 lut: np.ndarray, markov: bool, out: np.ndarray,
                 raw_mode: int = 0) -> None:
    """Decode unit streams (unit u at payload[offsets[u]:][:byte_lens[u]])
    into `out`, a (n_total,) uint8 array: unit u fills out[u * unit:][:
    unit]. raw_mode as in encode_units (literal units are copied)."""
    lib = require()
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    byte_lens = np.ascontiguousarray(byte_lens, dtype=np.int64)
    lut = np.ascontiguousarray(lut, dtype=np.uint16)
    n_units = len(byte_lens)
    if (out.dtype != np.uint8 or not out.flags.c_contiguous
            or out.size != n_total or n_units != -(-n_total // unit)
            or len(offsets) != n_units):
        raise ValueError("decode_units: out, offsets and byte_lens do not "
                         "match n_total and unit")
    if n_units and (offsets.min() < 0 or byte_lens.min() < 0 or
                    (offsets + byte_lens).max() > payload.size):
        raise ValueError("mhc: corrupt container (unit stream outside "
                         "the payload)")
    lib.mhc_decode_units(payload.ctypes.data, offsets.ctypes.data,
                         byte_lens.ctypes.data, n_units, unit, n_total,
                         lut.ctypes.data, 1 if markov else 0,
                         out.ctypes.data, raw_mode)
