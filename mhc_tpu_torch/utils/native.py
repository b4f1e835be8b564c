"""ctypes binding for the repo's native host runtime (native/*.cpp).

The port's own binding to the C++ library that `mhc_tpu` also uses: the
deterministic Huffman length builder, the container's metadata decoder
and writer, the engine's unit plans, and the threaded host unit codec
of the hybrid executor (`join_rows` to `decode_units`). The library is
a requirement of the port, as `nvcc` is for its kernels: every binding
calls it, and a library that cannot be built or loaded raises
RuntimeError with the reason, the compiler's output included.

The port compiles `native/mhc_host.cpp`, `native/mhc_codec.cpp` and its
own `utils/container_writer.cpp` (the container writer's table section
and unit index: `write_tables`, `write_index`) and `utils/unit_plan.cpp`
(the engine's unit plans: `plan_encode`, `plan_decode`) with the flags of
`native/Makefile` into its own library under `build/mhc_tpu_torch/`,
and never writes into `native/`. The build goes to a per-process
temporary file that `os.replace` puts in place, so a loader in another
process sees either no library or a whole one. It is rebuilt when it is
older than any of its sources.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess

import numpy as np

from ..ops.huffman import MAX_CODE_LEN

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO, "native")
SOURCES = (*(os.path.join(_NATIVE, f)
              for f in ("mhc_host.cpp", "mhc_codec.cpp")),
           *(os.path.join(os.path.dirname(os.path.abspath(__file__)), f)
             for f in ("container_writer.cpp", "unit_plan.cpp")))
# native/Makefile's CXXFLAGS and its -shared
CXXFLAGS = ["-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread",
            "-shared"]
BUILD_DIR = os.path.join(_REPO, "build", "mhc_tpu_torch")
LIB_NAME = "libmhc_host.so"

_HOST_VERSION = 2   # mhc_version()
_CODEC_VERSION = 5  # mhc_codec_version()

_lib = None


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile the host library into `build_dir` unless it is there and
    newer than every source; returns its path. Raises RuntimeError with
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
    """The host library of `build_dir`, built if stale, typed. Raises
    RuntimeError where it cannot be built (with the compiler's output)
    or loaded, or its versions are not the port's."""
    so = build(build_dir)
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        raise RuntimeError(f"cannot load {so}: {e}") from e
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
    lib.mhc_write_tables.argtypes = [
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.mhc_write_tables.restype = ctypes.c_int64
    lib.mhc_write_index.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.mhc_write_index.restype = ctypes.c_int64
    lib.mhc_plan_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.mhc_plan_encode.restype = ctypes.c_int64
    lib.mhc_plan_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.mhc_plan_decode.restype = ctypes.c_int64
    lib.mhc_codec_version.restype = ctypes.c_int
    lib.mhc_version.restype = ctypes.c_int
    versions = (lib.mhc_version(), lib.mhc_codec_version())
    if versions != (_HOST_VERSION, _CODEC_VERSION):
        raise RuntimeError(f"{so} has versions {versions}, the port "
                           f"{(_HOST_VERSION, _CODEC_VERSION)}")
    return lib


def require():
    """The port's host library (`BUILD_DIR`), loaded once; raises
    RuntimeError as `load` does."""
    global _lib
    if _lib is None:
        _lib = load(BUILD_DIR)
    return _lib


def code_lengths(scaled_counts: np.ndarray, max_len: int) -> np.ndarray:
    """Huffman code lengths for (..., 256) pre-rescaled counts, bit-identical
    to `ops.huffman.code_lengths_np`."""
    lib = require()
    counts = np.ascontiguousarray(scaled_counts, dtype=np.int32)
    flat = counts.reshape(-1, 256)
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
    lib = require()
    check_code_lengths(lengths)
    lens = np.ascontiguousarray(lengths, dtype=np.uint8)
    src = np.frombuffer(coded, dtype=np.uint8)
    out = np.empty(n_out, dtype=np.uint8)
    if n_out == 0:
        return out, 0
    used = lib.mhc_entropy_decode(src.ctypes.data, src.size,
                                  lens.ctypes.data, lens.shape[0], n_out,
                                  out.ctypes.data)
    if used < 0:
        raise ValueError("mhc: corrupt entropy-coded section")
    return out, int(used)


def write_tables(markov: bool, lengths: np.ndarray):
    """The container's table section (utils/container_writer.cpp): returns
    (bytes, packed), `packed` where the Markov lengths are entropy-coded.
    Lengths not uint8 of the mode's shape are converted here; raises
    ValueError where one is over 15."""
    lib = require()
    lens = np.ascontiguousarray(lengths, dtype=np.uint8).reshape(
        65536 if markov else 256)
    out = np.empty(32 + 128 * 256 + 8, np.uint8)
    packed = ctypes.c_int32()
    n = lib.mhc_write_tables(1 if markov else 0, lens.ctypes.data,
                             out.ctypes.data, ctypes.byref(packed))
    if n < 0:
        raise ValueError(f"code lengths over {MAX_CODE_LEN}")
    return out[:n].tobytes(), bool(packed.value)


def write_index(byte_lens: np.ndarray, groups: tuple):
    """The sub-stream unit index (utils/container_writer.cpp) in the
    first shortest of its forms: returns (bytes, form), form 0 the flat
    packed index, 1 the entropy-coded one, 2 + i the grouped index at
    `groups[i]`. Raises struct.error, as the reference's writer does,
    where the format cannot hold a length: one negative, or a base (the
    least length of the index or of a group) over the u16's 65535."""
    lib = require()
    lens = np.ascontiguousarray(byte_lens, dtype=np.int64)
    g = np.asarray(groups, np.int64)
    out = np.empty(3 + 8 * lens.size + 8, np.uint8)
    form = ctypes.c_int32()
    n = lib.mhc_write_index(lens.ctypes.data, lens.size, g.ctypes.data,
                            g.size, out.ctypes.data, ctypes.byref(form))
    if n < 0:
        raise struct.error("mhc: a unit length the index cannot hold")
    return out[:n].tobytes(), form.value


def _check_out(*arrays) -> None:
    """Raises ValueError unless each (array, dtype, size) is a writable
    C-contiguous array of that dtype and size: the plans write into them
    through bare pointers."""
    for a, dtype, size in arrays:
        if (a.dtype != dtype or a.size != size or not a.flags.c_contiguous
                or not a.flags.writeable):
            raise ValueError(f"plan output of {a.dtype} x {a.size} where "
                             f"{np.dtype(dtype)} x {size} is due")


def plan_encode(bits: np.ndarray, orig_len: int, du: int, literal: bool,
                aligned: bool, bit_lens: np.ndarray, byte_lens: np.ndarray,
                bounds: np.ndarray, flags: np.ndarray):
    """The encode's unit plan (utils/unit_plan.cpp) of R units from their
    (R,) int32 coded bit counts, written into `bit_lens`, `byte_lens`
    ((R,) int64), `bounds` ((R + 1,) int64) and `flags` ((R,) uint8);
    returns the total words."""
    lib = require()
    b = np.ascontiguousarray(bits, np.int32)
    R = b.size
    _check_out((bit_lens, np.int64, R), (byte_lens, np.int64, R),
               (bounds, np.int64, R + 1), (flags, np.uint8, R))
    return int(lib.mhc_plan_encode(
        b.ctypes.data, R, orig_len, du, int(literal), int(aligned),
        bit_lens.ctypes.data, byte_lens.ctypes.data, bounds.ctypes.data,
        flags.ctypes.data))


def plan_decode(byte_lens: np.ndarray, bit_lens, orig_len: int, du: int,
                aligned: bool, literal: bool, worst: int, bounds: np.ndarray,
                n_dec: np.ndarray, rows: np.ndarray):
    """The decode's unit plan (utils/unit_plan.cpp) of R units from their
    stored bytes (and bit lengths, or None), written into `bounds` ((R +
    1,) int64), `n_dec` ((R,) int32) and the first entries of `rows` ((R,)
    int64); returns (the expansion's row width in words, the literal
    count). Raises ValueError where a unit's stored bytes exceed `worst`
    or cannot hold its symbols."""
    lib = require()
    sl = np.ascontiguousarray(byte_lens, np.int64)
    R = sl.size
    bl = None if bit_lens is None else np.ascontiguousarray(bit_lens,
                                                            np.int64)
    if bl is not None and bl.size != R:
        raise ValueError("bit_lens and byte_lens differ in length")
    _check_out((bounds, np.int64, R + 1), (n_dec, np.int32, R),
               (rows, np.int64, R))
    width = ctypes.c_int64()
    n_raw = lib.mhc_plan_decode(
        sl.ctypes.data, None if bl is None else bl.ctypes.data, R, orig_len,
        du, int(aligned), int(literal), worst, bounds.ctypes.data,
        n_dec.ctypes.data, rows.ctypes.data, ctypes.byref(width))
    if n_raw < 0:
        raise ValueError("mhc: corrupt container (unit length)")
    return width.value, int(n_raw)


# ---------------------------------------------------------------------------
# The host unit codec (native/mhc_codec.cpp, threaded): bit-identical to
# the device path by construction, so the hybrid executor may give any
# unit to either.
# ---------------------------------------------------------------------------

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
