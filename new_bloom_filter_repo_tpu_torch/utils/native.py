"""ctypes binding to the native host runtime (native/nbf.cpp).

Builds libnbf.so (g++ via the bundled Makefile) when the package is
imported, and exposes xxh64, batched index-table precompute,
multi-threaded frame DEFLATE/INFLATE, padded-row stream compaction, and
the Y4M prober.  This is the PyTorch port's copy of
``new_bloom_filter_repo_tpu.utils.native``; both packages bind the same
``native/libnbf.so`` at the repository root.

The library is not in git, so a fresh checkout builds it, and processes
started together (test workers, say) may all find it missing.
:func:`ensure_built` builds it once across processes (an ``flock`` on
``build/native/libnbf.lock``), in a private directory, and renames the
result into place, so no process of either package can open a
half-written library; the new file is younger than its sources, so the
JAX package's loader takes it as it is.  When the library cannot be
built or loaded, :func:`load` raises ``RuntimeError`` with the build's
output: the port never runs the Python paths below in its place, since
they make other encoder choices than the library does.  Those paths
stay for callers that force them on purpose.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_LIB_NAME = "libnbf.so"
_SOURCES = ("nbf.cpp", "Makefile")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_has_rans8 = False
_has_ransc = False
_has_rans_trials = False
_has_unfilter_med = False
_has_hist = False
_has_rans2 = False
_has_bitpack = False
_has_fast_deflate = False
_has_huf = False


def _stale(native_dir: str = _NATIVE_DIR) -> bool:
    """True when libnbf.so predates its sources (or is absent): a
    stale binary silently drops newer entry points AND whatever
    optional system libs (libdeflate) the build machine lacked, so the
    loader rebuilds instead of trusting it."""
    try:
        so_m = os.path.getmtime(os.path.join(native_dir, _LIB_NAME))
    except OSError:
        return True
    for src in _SOURCES:
        try:
            if os.path.getmtime(os.path.join(native_dir, src)) > so_m:
                return True
        except OSError:
            pass
    return False


def ensure_built(native_dir: str = _NATIVE_DIR,
                 build_dir: str = _BUILD_DIR) -> bool:
    """Build ``native_dir/libnbf.so`` if it is absent or older than its
    sources; True when this call compiled it.

    Processes that call this together build once: each takes an
    exclusive ``flock`` on ``build_dir/libnbf.lock`` and checks the
    library again under it.  The build copies the sources into a fresh
    directory under ``build_dir`` and runs ``make libnbf.so`` there (the
    Makefile stays the one source of the flags), then renames the
    library onto ``native_dir/libnbf.so``: atomic on one filesystem, so
    a reader sees the old file or the whole new one.  Raises
    ``RuntimeError`` with make's output when the build fails."""
    if not _stale(native_dir):
        return False
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "libnbf.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(native_dir):
            return False
        work = tempfile.mkdtemp(dir=build_dir)
        try:
            for src in _SOURCES:
                shutil.copy(os.path.join(native_dir, src), work)
            try:
                proc = subprocess.run(["make", "-C", work, _LIB_NAME],
                                      capture_output=True, text=True,
                                      timeout=600)
            except (OSError, subprocess.TimeoutExpired) as exc:
                raise RuntimeError(f"could not build {_LIB_NAME} from "
                                   f"{native_dir}: {exc}") from exc
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {_LIB_NAME} from {native_dir} failed "
                    f"(make exit {proc.returncode}):\n{proc.stdout}"
                    f"{proc.stderr}")
            os.replace(os.path.join(work, _LIB_NAME),
                       os.path.join(native_dir, _LIB_NAME))
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return True


def open_library(native_dir: str = _NATIVE_DIR,
                 build_dir: str = _BUILD_DIR) -> ctypes.CDLL:
    """``native_dir/libnbf.so``, built first if needed
    (:func:`ensure_built`); raises ``RuntimeError`` when it cannot be
    built or loaded."""
    ensure_built(native_dir, build_dir)
    path = os.path.join(native_dir, _LIB_NAME)
    try:
        return ctypes.CDLL(path)
    except OSError as exc:
        raise RuntimeError(f"cannot load {path}: {exc}") from exc


def load() -> ctypes.CDLL:
    """The native library, built if needed; raises ``RuntimeError``
    when it cannot be built or loaded (never returns None)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = open_library()
        u64, u32, i32 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int
        p8 = ctypes.POINTER(ctypes.c_uint8)
        pp8 = ctypes.POINTER(p8)
        pu64 = ctypes.POINTER(u64)
        pu32 = ctypes.POINTER(u32)
        lib.nbf_xxh64.restype = u64
        lib.nbf_xxh64.argtypes = [p8, u64, u64]
        lib.nbf_xxh64_index_table.restype = None
        lib.nbf_xxh64_index_table.argtypes = [u64, u64, u64, u64,
                                              pu64, pu64, pu64, i32]
        lib.nbf_deflate_frames.restype = i32
        lib.nbf_deflate_frames.argtypes = [i32, pp8, pu64, pp8, pu64,
                                           pu64, i32, i32]
        global _has_fast_deflate
        try:  # absent from pre-round-4 builds of libnbf.so
            lib.nbf_deflate_frames_fast.restype = i32
            lib.nbf_deflate_frames_fast.argtypes = [i32, pp8, pu64, pp8,
                                                    pu64, pu64, i32, i32]
            _has_fast_deflate = True
        except AttributeError:
            _has_fast_deflate = False
        lib.nbf_inflate_frames.restype = i32
        lib.nbf_inflate_frames.argtypes = [i32, pp8, pu64, pp8, pu64,
                                           pu64, i32]
        lib.nbf_strip_rows.restype = u64
        lib.nbf_strip_rows.argtypes = [p8, u64, u64, pu32, p8]
        lib.nbf_pad_rows.restype = None
        lib.nbf_pad_rows.argtypes = [p8, u64, u64, pu32, p8]
        lib.nbf_y4m_probe.restype = i32
        lib.nbf_y4m_probe.argtypes = [p8, u64, pu32, pu32, pu32, pu32,
                                      pu32, pu32]
        pi32 = ctypes.POINTER(ctypes.c_int32)
        lib.nbf_pack_subfilters.restype = None
        lib.nbf_pack_subfilters.argtypes = [pi32, u64, i32, i32, p8]
        lib.nbf_unpack_subfilters.restype = None
        lib.nbf_unpack_subfilters.argtypes = [p8, u64, i32, i32, pi32]
        lib.nbf_witness_popcounts.restype = None
        lib.nbf_witness_popcounts.argtypes = [p8, u64, u64, pi32, pi32]
        lib.nbf_rans_encode.restype = u64
        lib.nbf_rans_encode.argtypes = [p8, u64, i32, p8, u64]
        lib.nbf_rans_decode.restype = i32
        lib.nbf_rans_decode.argtypes = [p8, u64, i32, p8, u64]
        global _has_rans8, _has_ransc
        try:  # absent from pre-round-3 builds of libnbf.so
            lib.nbf_rans8_encode.restype = u64
            lib.nbf_rans8_encode.argtypes = [p8, u64, p8, u64]
            lib.nbf_rans8_decode.restype = i32
            lib.nbf_rans8_decode.argtypes = [p8, u64, p8, u64]
            _has_rans8 = True
        except AttributeError:
            _has_rans8 = False
        try:
            lib.nbf_ransc_encode.restype = u64
            lib.nbf_ransc_encode.argtypes = [p8, u64, p8, u64]
            lib.nbf_ransc_decode.restype = i32
            lib.nbf_ransc_decode.argtypes = [p8, u64, p8, u64]
            _has_ransc = True
        except AttributeError:
            _has_ransc = False
        global _has_rans_trials
        try:
            pp8 = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
            pu64 = ctypes.POINTER(u64)
            lib.nbf_rans_trials.restype = None
            lib.nbf_rans_trials.argtypes = [i32, pp8, pu64, pp8, pu64,
                                            pu64, p8, i32]
            _has_rans_trials = True
        except AttributeError:
            _has_rans_trials = False
        global _has_unfilter_med
        try:
            lib.nbf_unfilter_med.restype = None
            lib.nbf_unfilter_med.argtypes = [p8, u64, u64, u64]
            _has_unfilter_med = True
        except AttributeError:
            _has_unfilter_med = False
        global _has_hist
        try:
            lib.nbf_byte_hist.restype = None
            lib.nbf_byte_hist.argtypes = [p8, u64, pu64]
            lib.nbf_popcount.restype = u64
            lib.nbf_popcount.argtypes = [p8, u64]
            _has_hist = True
        except AttributeError:
            _has_hist = False
        global _has_bitpack
        try:
            lib.nbf_bitpack_rows.restype = u64
            lib.nbf_bitpack_rows.argtypes = [p8, u64, u64, pi32, p8]
            lib.nbf_bitunpack_rows.restype = i32
            lib.nbf_bitunpack_rows.argtypes = [p8, u64, u64, u64, pi32,
                                               p8]
            _has_bitpack = True
        except AttributeError:
            _has_bitpack = False
        global _has_huf
        try:
            pu16 = ctypes.POINTER(ctypes.c_uint16)
            lib.nbf_huf_decode.restype = i32
            lib.nbf_huf_decode.argtypes = [p8, u64, u64, pi32,
                                           ctypes.POINTER(u64), i32,
                                           pu16, u64]
            _has_huf = True
        except AttributeError:
            _has_huf = False
        global _has_rans2
        try:
            lib.nbf_rans2_encode.restype = u64
            lib.nbf_rans2_encode.argtypes = [p8, u64, u64, p8, u64]
            lib.nbf_rans2_decode.restype = i32
            lib.nbf_rans2_decode.argtypes = [p8, u64, u64, p8, u64]
            lib.nbf_rans_trials2.restype = None
            lib.nbf_rans_trials2.argtypes = [
                i32, ctypes.POINTER(p8), pu64, pu64,
                ctypes.POINTER(p8), pu64, pu64, p8, i32]
            _has_rans2 = True
        except AttributeError:
            _has_rans2 = False
        _lib = lib
        return _lib


def available() -> bool:
    """True; raises like :func:`load` when the library cannot be had."""
    return load() is not None


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ---------------------------------------------------------------------------
# xxh64
# ---------------------------------------------------------------------------

def xxh64(data: bytes, seed: int = 0) -> int:
    lib = load()
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(
        1, np.uint8)
    return int(lib.nbf_xxh64(_as_u8p(buf), len(data), seed))


def xxh64_index_tables(n: int, h1_seed: int, h2_seed: int, act_seed: int,
                       threads: int = 0):
    """(h1, h2, act) uint64[n] hashes of str(i) — host-side precompute."""
    lib = load()
    h1 = np.empty(n, np.uint64)
    h2 = np.empty(n, np.uint64)
    act = np.empty(n, np.uint64)
    threads = threads or (os.cpu_count() or 1)
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    lib.nbf_xxh64_index_table(
        n, h1_seed, h2_seed, act_seed,
        h1.ctypes.data_as(pu64), h2.ctypes.data_as(pu64),
        act.ctypes.data_as(pu64), threads)
    return h1, h2, act


# ---------------------------------------------------------------------------
# Threaded frame zlib
# ---------------------------------------------------------------------------

def deflate_frames(buffers: Sequence[bytes], level: int = 6,
                   threads: int = 0, engine: str = "zlib") -> List[bytes]:
    """zlib-compress independent buffers, in parallel when native.

    ``engine="fast"`` opts into libdeflate (when the native build has
    it): standard zlib streams any inflater reads, ~3x throughput.
    Framework-owned section formats use it; paths pinned to the
    reference's exact zlib bytes (keyframe records mirroring
    fixed_video_compressor.py:31) keep the default ``"zlib"``.
    """
    lib = load()
    if lib is None:
        return [zlib.compress(b, level) for b in buffers]
    count = len(buffers)
    if count == 0:
        return []
    threads = threads or (os.cpu_count() or 1)
    ins = [np.frombuffer(b, np.uint8) if b else np.zeros(1, np.uint8)
           for b in buffers]
    caps = [len(b) + (len(b) >> 9) + 64 for b in buffers]
    outs = [np.empty(c, np.uint8) for c in caps]
    p8 = ctypes.POINTER(ctypes.c_uint8)
    in_arr = (p8 * count)(*[_as_u8p(a) for a in ins])
    out_arr = (p8 * count)(*[_as_u8p(a) for a in outs])
    in_len = (ctypes.c_uint64 * count)(*[len(b) for b in buffers])
    out_cap = (ctypes.c_uint64 * count)(*caps)
    out_len = (ctypes.c_uint64 * count)()
    fn = (lib.nbf_deflate_frames_fast
          if engine == "fast" and _has_fast_deflate
          else lib.nbf_deflate_frames)
    rc = fn(count, in_arr, in_len, out_arr, out_cap, out_len, level,
            threads)
    if rc != 0:
        return [zlib.compress(b, level) for b in buffers]
    return [outs[i][: out_len[i]].tobytes() for i in range(count)]


def inflate_frames(buffers: Sequence[bytes], sizes: Sequence[int],
                   threads: int = 0) -> List[bytes]:
    """zlib-decompress independent buffers with known raw sizes."""
    lib = load()
    if lib is None:
        return [zlib.decompress(b) for b in buffers]
    count = len(buffers)
    if count == 0:
        return []
    threads = threads or (os.cpu_count() or 1)
    ins = [np.frombuffer(b, np.uint8) if b else np.zeros(1, np.uint8)
           for b in buffers]
    outs = [np.empty(max(1, s), np.uint8) for s in sizes]
    p8 = ctypes.POINTER(ctypes.c_uint8)
    in_arr = (p8 * count)(*[_as_u8p(a) for a in ins])
    out_arr = (p8 * count)(*[_as_u8p(a) for a in outs])
    in_len = (ctypes.c_uint64 * count)(*[len(b) for b in buffers])
    out_cap = (ctypes.c_uint64 * count)(*[max(1, s) for s in sizes])
    out_len = (ctypes.c_uint64 * count)()
    rc = lib.nbf_inflate_frames(count, in_arr, in_len, out_arr, out_cap,
                                out_len, threads)
    if rc != 0:
        return [zlib.decompress(b) for b in buffers]
    return [outs[i][: out_len[i]].tobytes() for i in range(count)]


def inflate_one(data: bytes, raw_len: int) -> Optional[bytes]:
    """Single zlib-stream inflate with a known (or capped) raw size —
    libdeflate when built in, 2-3x zlib's throughput on the decode
    record-parse path.  Returns None when the native build is absent or
    the stream doesn't fit ``raw_len`` (callers fall back to
    zlib.decompress, preserving its exception behavior on corrupt or
    oversized streams)."""
    lib = load()
    if lib is None or not data or raw_len <= 0:
        return None
    arr = np.frombuffer(data, np.uint8)
    out = np.empty(raw_len, np.uint8)
    p8 = ctypes.POINTER(ctypes.c_uint8)
    in_arr = (p8 * 1)(_as_u8p(arr))
    out_arr = (p8 * 1)(_as_u8p(out))
    in_len = (ctypes.c_uint64 * 1)(len(data))
    out_cap = (ctypes.c_uint64 * 1)(raw_len)
    out_len = (ctypes.c_uint64 * 1)()
    rc = lib.nbf_inflate_frames(1, in_arr, in_len, out_arr, out_cap,
                                out_len, 1)
    if rc != 0:
        return None
    return out[: out_len[0]].tobytes()


# ---------------------------------------------------------------------------
# Padded-row compaction
# ---------------------------------------------------------------------------

def strip_rows(arr2d: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate arr2d[i, :lengths[i]] (native memcpy walk)."""
    lib = load()
    arr2d = np.ascontiguousarray(arr2d, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.uint32)
    if lib is None:
        cols = np.arange(arr2d.shape[1])
        return arr2d[cols[None, :] < lengths[:, None]]
    total = int(lengths.sum())
    out = np.empty(total, np.uint8)
    lib.nbf_strip_rows(
        _as_u8p(arr2d), arr2d.shape[0], arr2d.shape[1],
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _as_u8p(out))
    return out


def pad_rows(stream: np.ndarray, rows: int, stride: int,
             lengths: np.ndarray,
             out: Optional[np.ndarray] = None) -> np.ndarray:
    """Inverse of strip_rows: (rows, stride) zero-padded.

    ``out`` (optional C-contiguous (rows, stride) uint8, e.g. one
    frame's slice of a chunk-batch array) receives the result in place
    — the native walk zero-fills and writes it in one pass, saving the
    per-call allocation plus the copy-back that dominated the decode
    slicing stage on large chunks."""
    lib = load()
    stream = np.ascontiguousarray(stream, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.uint32)
    if int(lengths.sum()) > stream.size:
        # corrupt/truncated stream: fail like the numpy path instead of
        # letting the native memcpy walk read out of bounds
        raise ValueError(
            f"stream carries {stream.size} bytes but row lengths sum to "
            f"{int(lengths.sum())}")
    if lengths.size and int(lengths.max()) > stride:
        raise ValueError("row length exceeds stride")
    if out is None:
        out = np.empty((rows, stride), np.uint8)
    elif (out.shape != (rows, stride) or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise ValueError("out must be C-contiguous (rows, stride) uint8")
    if lib is None:
        out[:] = 0
        cols = np.arange(stride)
        out[cols[None, :] < lengths[:, None]] = stream[: int(lengths.sum())]
        return out
    lib.nbf_pad_rows(
        _as_u8p(stream), rows, stride,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _as_u8p(out))
    return out


# ---------------------------------------------------------------------------
# Sub-filter bitmap pack/unpack (blocked-record bitmap section)
# ---------------------------------------------------------------------------

def pack_subfilters(words: np.ndarray, m: int) -> np.ndarray:
    """(NB, nw) i32 packed sub-filter words -> packbits bytes of the
    concatenated m-bit-per-block bitmap (the blocked record's bitmap
    section).  Native single pass; numpy fallback goes through the
    expanded-bit form."""
    lib = load()
    nb, nw = words.shape
    if m > nw * 32:
        raise ValueError(f"m={m} exceeds word capacity {nw * 32}")
    if lib is not None:
        words = np.ascontiguousarray(words, np.int32)
        out = np.empty((nb * m + 7) // 8, np.uint8)
        lib.nbf_pack_subfilters(
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nb, nw, m, _as_u8p(out))
        return out
    u = words.astype(np.uint32)
    by = np.stack([(u >> 24) & 0xFF, (u >> 16) & 0xFF, (u >> 8) & 0xFF,
                   u & 0xFF], axis=-1).astype(np.uint8)
    bits = np.unpackbits(by.reshape(nb, -1), axis=1)[:, :m]
    return np.packbits(bits.reshape(-1))


def unpack_subfilters(bitmap: np.ndarray, nb: int, m: int,
                      nw: int) -> np.ndarray:
    """Inverse of :func:`pack_subfilters`: bitmap bytes -> (nb, nw) i32
    packed words (tail bits zero)."""
    lib = load()
    bitmap = np.ascontiguousarray(bitmap, np.uint8)
    if bitmap.size * 8 < nb * m:
        raise ValueError("bitmap shorter than nb*m bits")
    if lib is not None:
        out = np.empty((nb, nw), np.int32)
        lib.nbf_unpack_subfilters(
            _as_u8p(bitmap), nb, m, nw,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    bits = np.unpackbits(bitmap)[: nb * m].reshape(nb, m)
    wbits = np.zeros((nb, nw * 32), np.uint8)
    wbits[:, :m] = bits
    by = np.packbits(wbits, axis=1)
    u = ((by[:, 0::4].astype(np.uint32) << 24)
         | (by[:, 1::4].astype(np.uint32) << 16)
         | (by[:, 2::4].astype(np.uint32) << 8)
         | by[:, 3::4].astype(np.uint32))
    return u.view(np.int32)


def bitpack_rows(rows: np.ndarray, bits: np.ndarray) -> bytes:
    """Concatenate the first ``bits[r]`` bits of each byte-aligned row
    (MSB-first) into one contiguous bit stream — drops the per-block
    byte padding of witness sections (coding 7)."""
    rows = np.ascontiguousarray(rows, np.uint8)
    bits = np.ascontiguousarray(bits, np.int32)
    nrows, stride = rows.shape
    if bits.size != nrows:
        raise ValueError("bits length must match row count")
    if bits.size and (int(bits.max()) > stride * 8 or int(bits.min()) < 0):
        raise ValueError("row bit length exceeds stride")
    lib = load()
    if lib is not None and _has_bitpack:
        out = np.empty((int(bits.sum()) + 7) // 8 + 1, np.uint8)
        n = lib.nbf_bitpack_rows(_as_u8p(rows), nrows, stride,
                                 bits.ctypes.data_as(
                                     ctypes.POINTER(ctypes.c_int32)),
                                 _as_u8p(out))
        return out[:n].tobytes()
    expanded = np.unpackbits(rows, axis=1)
    mask = np.arange(stride * 8) < bits[:, None]
    return np.packbits(expanded[mask]).tobytes()


def bitunpack_rows(packed: bytes, nrows: int, stride: int,
                   bits: np.ndarray) -> np.ndarray:
    """Inverse of :func:`bitpack_rows`: (nrows, stride) zero-padded
    byte-aligned rows.  Raises ValueError on a short stream."""
    bits = np.ascontiguousarray(bits, np.int32)
    if bits.size != nrows:
        raise ValueError("bits length must match row count")
    if bits.size and (int(bits.max()) > stride * 8 or int(bits.min()) < 0):
        raise ValueError("row bit length exceeds stride")
    lib = load()
    if lib is not None and _has_bitpack:
        arr = (np.frombuffer(packed, np.uint8) if packed
               else np.zeros(1, np.uint8))
        out = np.empty((nrows, stride), np.uint8)
        rc = lib.nbf_bitunpack_rows(
            _as_u8p(arr), len(packed), nrows, stride,
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _as_u8p(out))
        if rc != 0:
            raise ValueError("bit-packed stream shorter than row bits")
        return out
    total = int(bits.sum())
    allbits = np.unpackbits(np.frombuffer(packed, np.uint8))
    if allbits.size < total:
        raise ValueError("bit-packed stream shorter than row bits")
    expanded = np.zeros((nrows, stride * 8), np.uint8)
    mask = np.arange(stride * 8) < bits[:, None]
    expanded[mask] = allbits[:total]
    return np.packbits(expanded, axis=1)


# ---------------------------------------------------------------------------
# Static binary rANS section coder (see native/nbf.cpp)
# ---------------------------------------------------------------------------

_RANS_BITS = 12
_RANS_M = 1 << _RANS_BITS
_RANS_L = 1 << 23


# popcount-by-byte lookup: bincount + dot touches len(data) + 256
# elements, vs np.unpackbits materializing an 8x temporary (this fn
# runs 3x/frame in the encoder's section-coding hot loop).
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def byte_hist(data: bytes) -> np.ndarray:
    """256-bin byte histogram (int64) — native single-pass walk when
    libnbf is built, np.bincount otherwise.  Shared by the encoder's
    entropy gates (entropy_bits, rans_bit_prob, DEFLATE-unwinnable)."""
    arr = np.frombuffer(data, np.uint8)
    lib = load()
    if lib is not None and _has_hist and arr.size:
        out = np.zeros(256, np.uint64)
        lib.nbf_byte_hist(_as_u8p(arr), arr.size,
                          out.ctypes.data_as(ctypes.POINTER(
                              ctypes.c_uint64)))
        return out.astype(np.int64)
    return np.bincount(arr, minlength=256).astype(np.int64)


def popcount_bytes(data: bytes) -> int:
    """Total set bits of ``data``."""
    arr = np.frombuffer(data, np.uint8)
    lib = load()
    if lib is not None and _has_hist and arr.size:
        return int(lib.nbf_popcount(_as_u8p(arr), arr.size))
    return int(np.bincount(arr, minlength=256) @ _POP8)


def rans_bit_prob(data: bytes) -> int:
    """Quantized P(bit = 1) of a packed bit stream, in [1, 255]."""
    if not data:
        return 128
    ones = popcount_bytes(data)
    p = round(256 * ones / (8 * len(data)))
    return min(255, max(1, p))


def _rans_table(prob: int):
    """Exact-integer table build mirroring rans_build_table in
    native/nbf.cpp bit for bit (Python ints are exact, so this fallback
    interoperates with native-coded streams)."""
    a, b = prob, 256 - prob
    f = []
    for s in range(256):
        k = bin(s).count("1")
        w = (a ** k) * (b ** (8 - k))
        fi = (w * _RANS_M) >> 64
        f.append(max(1, fi))
    maxs = f.index(max(f))  # first max — matches C's strict-> scan
    f[maxs] += _RANS_M - sum(f)
    start, c = [], 0
    slot2sym = np.empty(_RANS_M, np.uint8)
    for s in range(256):
        start.append(c)
        slot2sym[c:c + f[s]] = s
        c += f[s]
    return f, start, slot2sym


def rans_encode(data: bytes, prob: int) -> Optional[bytes]:
    """rANS-encode; returns None when coding would not shrink below the
    input size (the caller then keeps another coding)."""
    lib = load()
    cap = len(data) + 16
    if lib is not None:
        arr = (np.frombuffer(data, np.uint8) if data
               else np.zeros(1, np.uint8))
        out = np.empty(cap, np.uint8)
        n = lib.nbf_rans_encode(_as_u8p(arr), len(data), prob,
                                _as_u8p(out), cap)
        return out[:n].tobytes() if n else None
    freq, start, _ = _rans_table(prob)
    buf = bytearray()
    x = _RANS_L
    for s in reversed(data):
        fr = freq[s]
        x_max = ((_RANS_L >> _RANS_BITS) << 8) * fr
        while x >= x_max:
            buf.append(x & 0xFF)
            x >>= 8
        x = ((x // fr) << _RANS_BITS) + (x % fr) + start[s]
    head = bytes(((x >> (8 * i)) & 0xFF) for i in range(4))
    out = head + bytes(reversed(buf))
    return out if len(out) <= cap else None


def rans_decode(data: bytes, prob: int, raw_len: int) -> bytes:
    lib = load()
    if lib is not None:
        arr = (np.frombuffer(data, np.uint8) if data
               else np.zeros(1, np.uint8))
        out = np.empty(max(1, raw_len), np.uint8)
        rc = lib.nbf_rans_decode(_as_u8p(arr), len(data), prob,
                                 _as_u8p(out), raw_len)
        if rc != 0:
            raise ValueError(f"malformed rANS section (rc={rc})")
        return out[:raw_len].tobytes()
    if len(data) < 4:
        raise ValueError("malformed rANS section (too short)")
    freq, start, slot2sym = _rans_table(prob)
    x = int.from_bytes(data[:4], "little")
    pos = 4
    out = bytearray()
    for _ in range(raw_len):
        slot = x & (_RANS_M - 1)
        s = int(slot2sym[slot])
        out.append(s)
        x = freq[s] * (x >> _RANS_BITS) + slot - start[s]
        while x < _RANS_L:
            if pos >= len(data):
                raise ValueError("malformed rANS section (underrun)")
            x = (x << 8) | data[pos]
            pos += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# Histogram byte rANS (section coding 3; see native/nbf.cpp)
# ---------------------------------------------------------------------------

_RANS8_TBL = 384


def _rans8_quantize(hist: np.ndarray, total: int) -> Optional[list]:
    """12-bit frequency quantization, mirroring rans8_quantize in
    native/nbf.cpp bit for bit (first-max tie-breaks included)."""
    fr = [0] * 256
    npresent = 0
    for s in range(256):
        h = int(hist[s])
        if h:
            fr[s] = min(max(h * _RANS_M // total, 1), _RANS_M - 1)
            npresent += 1
    if npresent == 0:
        return None
    if npresent == 1:
        s = next(i for i in range(256) if fr[i])
        fr[s] = _RANS_M - 1
        fr[(s + 1) & 255] = 1
    total_f = sum(fr)
    while total_f > _RANS_M:
        maxs = fr.index(max(fr))
        take = min(total_f - _RANS_M, fr[maxs] - 1)
        if take == 0:
            return None
        fr[maxs] -= take
        total_f -= take
    if total_f < _RANS_M:
        fr[fr.index(max(fr))] += _RANS_M - total_f
    return fr


def _rans8_pack_table(freq) -> bytes:
    out = bytearray(_RANS8_TBL)
    for k in range(128):
        f0, f1 = freq[2 * k], freq[2 * k + 1]
        out[3 * k] = f0 & 0xFF
        out[3 * k + 1] = (f0 >> 8) | ((f1 & 0xF) << 4)
        out[3 * k + 2] = f1 >> 4
    return bytes(out)


def _rans8_unpack_table(data: bytes) -> list:
    freq = [0] * 256
    for k in range(128):
        b0, b1, b2 = data[3 * k], data[3 * k + 1], data[3 * k + 2]
        freq[2 * k] = b0 | ((b1 & 0xF) << 8)
        freq[2 * k + 1] = (b1 >> 4) | (b2 << 4)
    return freq


def rans8_encode(data: bytes) -> Optional[bytes]:
    """Order-0 byte-histogram rANS encode: [384-byte table][stream].
    Returns None when coding would not shrink below the input size."""
    if not data:
        return None
    cap = len(data) + _RANS8_TBL + 16
    lib = load()
    if lib is not None and _has_rans8:
        arr = np.frombuffer(data, np.uint8)
        out = np.empty(cap, np.uint8)
        n = lib.nbf_rans8_encode(_as_u8p(arr), len(data), _as_u8p(out),
                                 cap)
        return out[:n].tobytes() if n else None
    hist = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    freq = _rans8_quantize(hist, len(data))
    if freq is None:
        return None
    start, c = [0] * 256, 0
    for s in range(256):
        start[s] = c
        c += freq[s]
    buf = bytearray()
    x = _RANS_L
    for s in reversed(data):
        fr = freq[s]
        x_max = ((_RANS_L >> _RANS_BITS) << 8) * fr
        while x >= x_max:
            buf.append(x & 0xFF)
            x >>= 8
        x = ((x // fr) << _RANS_BITS) + (x % fr) + start[s]
    head = bytes(((x >> (8 * i)) & 0xFF) for i in range(4))
    out = _rans8_pack_table(freq) + head + bytes(reversed(buf))
    return out if len(out) <= cap else None


def rans8_decode(data: bytes, raw_len: int) -> bytes:
    lib = load()
    if lib is not None and _has_rans8:
        arr = (np.frombuffer(data, np.uint8) if data
               else np.zeros(1, np.uint8))
        out = np.empty(max(1, raw_len), np.uint8)
        rc = lib.nbf_rans8_decode(_as_u8p(arr), len(data), _as_u8p(out),
                                  raw_len)
        if rc != 0:
            raise ValueError(f"malformed rANS8 section (rc={rc})")
        return out[:raw_len].tobytes()
    if len(data) < _RANS8_TBL + 4:
        raise ValueError("malformed rANS8 section (too short)")
    freq = _rans8_unpack_table(data)
    if sum(freq) != _RANS_M:
        raise ValueError("malformed rANS8 section (corrupt table)")
    start, c = [0] * 256, 0
    slot2sym = np.empty(_RANS_M, np.uint8)
    for s in range(256):
        start[s] = c
        slot2sym[c:c + freq[s]] = s
        c += freq[s]
    stream = data[_RANS8_TBL:]
    x = int.from_bytes(stream[:4], "little")
    pos = 4
    out = bytearray()
    for _ in range(raw_len):
        slot = x & (_RANS_M - 1)
        s = int(slot2sym[slot])
        out.append(s)
        x = freq[s] * (x >> _RANS_BITS) + slot - start[s]
        while x < _RANS_L:
            if pos >= len(stream):
                raise ValueError("malformed rANS8 section (underrun)")
            x = (x << 8) | stream[pos]
            pos += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# Order-1 context byte rANS (section coding 4; see native/nbf.cpp)
# ---------------------------------------------------------------------------

_RANSC_NCTX = 8
_RANSC_TBL = _RANSC_NCTX * _RANS8_TBL

# ctx(prev byte) = log2 bucket of the residual magnitude min(v, 256-v):
# 0, 1, 2-3, 4-7, 8-15, 16-31, 32-63, >=64 -> buckets 0..7
_RANSC_CTX_LUT = np.zeros(256, np.uint8)
for _v in range(256):
    _mag = _v if _v < 128 else 256 - _v
    _RANSC_CTX_LUT[_v] = 0 if _mag == 0 else min(7, _mag.bit_length())
del _v, _mag


def entropy_bits(data: bytes) -> float:
    """Order-0 entropy of ``data`` in bits/byte — a true lower bound
    (up to table quantization) on what :func:`rans8_encode` can store,
    so callers can skip the coder when it cannot win."""
    if not data:
        return 0.0
    c = byte_hist(data)
    p = c[c > 0] / len(data)
    return float(-(p * np.log2(p)).sum())


def cond_entropy_bits(data: bytes, stride: int = 4) -> float:
    """Sampled order-1 conditional entropy (bits/byte) under the
    :func:`ransc_encode` context model — an estimate of what the
    context coder can reach, for trial gating.  Samples every
    ``stride``-th (prev, next) byte pair; on large streams the stride
    widens so the sample stays ~32K pairs (a gate with 2% slack does
    not need more, and the scan was the encoder's costliest host
    gate).  One joint (ctx, next) bincount replaces the previous
    8-way masked scans."""
    b = np.frombuffer(data, np.uint8)
    if b.size < 2:
        return 8.0
    stride = max(stride, b.size >> 15)
    idx = np.arange(1, b.size, stride)
    ctx = _RANSC_CTX_LUT[b[idx - 1]].astype(np.int32)
    joint = np.bincount(ctx * 256 + b[idx],
                        minlength=_RANSC_NCTX * 256).reshape(
                            _RANSC_NCTX, 256)
    ns = joint.sum(axis=1)
    p = joint / np.maximum(ns, 1)[:, None]
    plogp = np.where(joint > 0, p * np.log2(np.where(p > 0, p, 1.0)),
                     0.0)
    return float(-(ns * plogp.sum(axis=1)).sum() / idx.size)


def ransc_encode(data: bytes) -> Optional[bytes]:
    """Order-1 context rANS encode: [8 x 384-byte tables][stream].
    Returns None when coding would not fit under the input size plus
    table overhead (caller keeps another coding)."""
    if not data:
        return None
    cap = len(data) + _RANSC_TBL + 16
    lib = load()
    if lib is not None and _has_ransc:
        arr = np.frombuffer(data, np.uint8)
        out = np.empty(cap, np.uint8)
        n = lib.nbf_ransc_encode(_as_u8p(arr), len(data), _as_u8p(out),
                                 cap)
        return out[:n].tobytes() if n else None
    b = np.frombuffer(data, np.uint8)
    ctx = np.empty(len(b), np.uint8)
    ctx[0] = 0
    ctx[1:] = _RANSC_CTX_LUT[b[:-1]]
    freqs, starts, tables = [], [], []
    for c in range(_RANSC_NCTX):
        sel = b[ctx == c]
        if sel.size == 0:
            freqs.append(None)
            starts.append(None)
            tables.append(bytes(_RANS8_TBL))
            continue
        hist = np.bincount(sel, minlength=256)
        fr = _rans8_quantize(hist, int(sel.size))
        if fr is None:
            return None
        st, cc = [0] * 256, 0
        for s in range(256):
            st[s] = cc
            cc += fr[s]
        freqs.append(fr)
        starts.append(st)
        tables.append(_rans8_pack_table(fr))
    buf = bytearray()
    x = _RANS_L
    for i in range(len(b) - 1, -1, -1):
        c = int(ctx[i])
        s = int(b[i])
        fr = freqs[c][s]
        x_max = ((_RANS_L >> _RANS_BITS) << 8) * fr
        while x >= x_max:
            buf.append(x & 0xFF)
            x >>= 8
        x = ((x // fr) << _RANS_BITS) + (x % fr) + starts[c][s]
    head = bytes(((x >> (8 * i)) & 0xFF) for i in range(4))
    out = b"".join(tables) + head + bytes(reversed(buf))
    return out if len(out) <= cap else None


def ransc_decode(data: bytes, raw_len: int) -> bytes:
    lib = load()
    if lib is not None and _has_ransc:
        arr = (np.frombuffer(data, np.uint8) if data
               else np.zeros(1, np.uint8))
        out = np.empty(max(1, raw_len), np.uint8)
        rc = lib.nbf_ransc_decode(_as_u8p(arr), len(data), _as_u8p(out),
                                  raw_len)
        if rc != 0:
            raise ValueError(f"malformed rANSc section (rc={rc})")
        return out[:raw_len].tobytes()
    if len(data) < _RANSC_TBL + 4:
        raise ValueError("malformed rANSc section (too short)")
    freqs, starts, slots, used = [], [], [], []
    for c in range(_RANSC_NCTX):
        fr = _rans8_unpack_table(data[c * _RANS8_TBL:(c + 1) * _RANS8_TBL])
        tot = sum(fr)
        if tot == _RANS_M:
            st, cc = [0] * 256, 0
            s2s = np.empty(_RANS_M, np.uint8)
            for s in range(256):
                st[s] = cc
                s2s[cc:cc + fr[s]] = s
                cc += fr[s]
            freqs.append(fr)
            starts.append(st)
            slots.append(s2s)
            used.append(True)
        elif tot == 0:
            freqs.append(None)
            starts.append(None)
            slots.append(None)
            used.append(False)
        else:
            raise ValueError("malformed rANSc section (corrupt table)")
    stream = data[_RANSC_TBL:]
    x = int.from_bytes(stream[:4], "little")
    pos = 4
    out = bytearray()
    c = 0
    for _ in range(raw_len):
        if not used[c]:
            raise ValueError("malformed rANSc section (absent context)")
        slot = x & (_RANS_M - 1)
        s = int(slots[c][slot])
        out.append(s)
        x = freqs[c][s] * (x >> _RANS_BITS) + slot - starts[c][s]
        while x < _RANS_L:
            if pos >= len(stream):
                raise ValueError("malformed rANSc section (underrun)")
            x = (x << 8) | stream[pos]
            pos += 1
        c = int(_RANSC_CTX_LUT[s])
    return bytes(out)


# ---------------------------------------------------------------------------
# 2D-context byte rANS (section coding 6; see native/nbf.cpp)
# ---------------------------------------------------------------------------


def _rans2_ctx_array(b: np.ndarray, stride: int) -> np.ndarray:
    """Per-byte context of a raster plane under the 2D model:
    max(bucket(left), bucket(up)); zeros outside the plane."""
    left = np.zeros(b.size, np.uint8)
    left[1:] = b[:-1]
    up = np.zeros(b.size, np.uint8)
    if stride < b.size:
        up[stride:] = b[:-stride]
    return np.maximum(_RANSC_CTX_LUT[left], _RANSC_CTX_LUT[up])


def rans2_encode(data: bytes, stride: int) -> Optional[bytes]:
    """2D-context rANS encode of a raster plane with row pitch
    ``stride`` bytes: [8 x 384-byte tables][stream].  The stronger of
    the left/up neighbor's magnitude bucket selects the table —
    prediction error is 2D-correlated, recovering 2-8% over the
    horizontal-only coder at the same header cost.  Returns None when
    coding would not fit under the input size plus overhead."""
    if not data or stride <= 0:
        return None
    cap = len(data) + _RANSC_TBL + 16
    lib = load()
    if lib is not None and _has_rans2:
        arr = np.frombuffer(data, np.uint8)
        out = np.empty(cap, np.uint8)
        n = lib.nbf_rans2_encode(_as_u8p(arr), len(data), stride,
                                 _as_u8p(out), cap)
        return out[:n].tobytes() if n else None
    b = np.frombuffer(data, np.uint8)
    ctx = _rans2_ctx_array(b, stride)
    freqs, starts, tables = [], [], []
    for c in range(_RANSC_NCTX):
        sel = b[ctx == c]
        if sel.size == 0:
            freqs.append(None)
            starts.append(None)
            tables.append(bytes(_RANS8_TBL))
            continue
        hist = np.bincount(sel, minlength=256)
        fr = _rans8_quantize(hist, int(sel.size))
        if fr is None:
            return None
        st, cc = [0] * 256, 0
        for s in range(256):
            st[s] = cc
            cc += fr[s]
        freqs.append(fr)
        starts.append(st)
        tables.append(_rans8_pack_table(fr))
    buf = bytearray()
    x = _RANS_L
    for i in range(len(b) - 1, -1, -1):
        c = int(ctx[i])
        s = int(b[i])
        fr = freqs[c][s]
        x_max = ((_RANS_L >> _RANS_BITS) << 8) * fr
        while x >= x_max:
            buf.append(x & 0xFF)
            x >>= 8
        x = ((x // fr) << _RANS_BITS) + (x % fr) + starts[c][s]
    head = bytes(((x >> (8 * i)) & 0xFF) for i in range(4))
    out = b"".join(tables) + head + bytes(reversed(buf))
    return out if len(out) <= cap else None


def rans2_decode(data: bytes, stride: int, raw_len: int) -> bytes:
    if stride <= 0:
        raise ValueError("rANS2 section stride must be positive")
    lib = load()
    if lib is not None and _has_rans2:
        arr = (np.frombuffer(data, np.uint8) if data
               else np.zeros(1, np.uint8))
        out = np.empty(max(1, raw_len), np.uint8)
        rc = lib.nbf_rans2_decode(_as_u8p(arr), len(data), stride,
                                  _as_u8p(out), raw_len)
        if rc != 0:
            raise ValueError(f"malformed rANS2 section (rc={rc})")
        return out[:raw_len].tobytes()
    if len(data) < _RANSC_TBL + 4:
        raise ValueError("malformed rANS2 section (too short)")
    freqs, starts, slots, used = [], [], [], []
    for c in range(_RANSC_NCTX):
        fr = _rans8_unpack_table(data[c * _RANS8_TBL:(c + 1) * _RANS8_TBL])
        tot = sum(fr)
        if tot == _RANS_M:
            st, cc = [0] * 256, 0
            s2s = np.empty(_RANS_M, np.uint8)
            for s in range(256):
                st[s] = cc
                s2s[cc:cc + fr[s]] = s
                cc += fr[s]
            freqs.append(fr)
            starts.append(st)
            slots.append(s2s)
            used.append(True)
        elif tot == 0:
            freqs.append(None)
            starts.append(None)
            slots.append(None)
            used.append(False)
        else:
            raise ValueError("malformed rANS2 section (corrupt table)")
    stream = data[_RANSC_TBL:]
    x = int.from_bytes(stream[:4], "little")
    pos = 4
    out = bytearray()
    for i in range(raw_len):
        cl = int(_RANSC_CTX_LUT[out[i - 1]]) if i else 0
        cu = int(_RANSC_CTX_LUT[out[i - stride]]) if i >= stride else 0
        c = cl if cl > cu else cu
        if not used[c]:
            raise ValueError("malformed rANS2 section (absent context)")
        slot = x & (_RANS_M - 1)
        s = int(slots[c][slot])
        out.append(s)
        x = freqs[c][s] * (x >> _RANS_BITS) + slot - starts[c][s]
        while x < _RANS_L:
            if pos >= len(stream):
                raise ValueError("malformed rANS2 section (underrun)")
            x = (x << 8) | stream[pos]
            pos += 1
    return bytes(out)


def cond2_entropy_bits(data: bytes, stride: int, sample: int = 4) -> float:
    """Sampled conditional entropy (bits/byte) under the
    :func:`rans2_encode` 2D context model, for trial gating — the 2D
    analogue of :func:`cond_entropy_bits` with the same ~32K-pair
    sample cap."""
    b = np.frombuffer(data, np.uint8)
    if b.size < 2 or stride <= 0:
        return 8.0
    sample = max(sample, b.size >> 15)
    idx = np.arange(1, b.size, sample)
    left = b[idx - 1]
    up = np.where(idx >= stride, b[np.maximum(idx - stride, 0)], 0)
    ctx = np.maximum(_RANSC_CTX_LUT[left],
                     _RANSC_CTX_LUT[up]).astype(np.int32)
    joint = np.bincount(ctx * 256 + b[idx],
                        minlength=_RANSC_NCTX * 256).reshape(
                            _RANSC_NCTX, 256)
    ns = joint.sum(axis=1)
    p = joint / np.maximum(ns, 1)[:, None]
    plogp = np.where(joint > 0, p * np.log2(np.where(p > 0, p, 1.0)),
                     0.0)
    return float(-(ns * plogp.sum(axis=1)).sum() / idx.size)


def rans_trials(buffers, coders, threads: int = 0, strides=None):
    """Run rANS encodes over independent buffers in the native thread
    pool: ``coders[i]`` is 3 (byte-histogram), 4 (order-1 context) or
    6 (2D context; needs ``strides[i]``).  Returns a list of
    Optional[bytes] — None where the coder declined (would not
    shrink).  Falls back to the serial per-buffer encoders when the
    pooled symbol is unavailable."""
    count = len(buffers)
    if count == 0:
        return []
    if strides is None:
        strides = [0] * count
    lib = load()
    pooled = (lib is not None and _has_rans_trials
              and (_has_rans2 or 6 not in coders))
    if not pooled:
        out = []
        for b, c, st in zip(buffers, coders, strides):
            out.append(rans8_encode(b) if c == 3 else
                       ransc_encode(b) if c == 4 else
                       rans2_encode(b, st) if c == 6 else None)
        return out
    threads = threads or (os.cpu_count() or 1)
    ins = [np.frombuffer(b, np.uint8) if b else np.zeros(1, np.uint8)
           for b in buffers]
    caps = [len(b) + (_RANSC_TBL if c in (4, 6) else _RANS8_TBL) + 16
            for b, c in zip(buffers, coders)]
    outs = [np.empty(c, np.uint8) for c in caps]
    p8 = ctypes.POINTER(ctypes.c_uint8)
    in_arr = (p8 * count)(*[_as_u8p(a) for a in ins])
    out_arr = (p8 * count)(*[_as_u8p(a) for a in outs])
    in_len = (ctypes.c_uint64 * count)(*[len(b) for b in buffers])
    out_cap = (ctypes.c_uint64 * count)(*caps)
    out_len = (ctypes.c_uint64 * count)()
    coder_arr = np.asarray(coders, np.uint8)
    if _has_rans2:
        stride_arr = (ctypes.c_uint64 * count)(*[int(s) for s in strides])
        lib.nbf_rans_trials2(count, in_arr, in_len, stride_arr, out_arr,
                             out_cap, out_len, _as_u8p(coder_arr), threads)
    else:
        lib.nbf_rans_trials(count, in_arr, in_len, out_arr, out_cap,
                            out_len, _as_u8p(coder_arr), threads)
    return [outs[i][: out_len[i]].tobytes() if out_len[i] else None
            for i in range(count)]


def unfilter_med(arr: np.ndarray) -> np.ndarray:
    """Invert the MED (LOCO-I) spatial filter over a (h, w) or
    (h, w, c) uint8 residual array — sequential raster reconstruction
    (each prediction reads reconstructed neighbors), so the hot path is
    native (nbf_unfilter_med); the numpy fallback vectorizes over
    channels only."""
    a = np.ascontiguousarray(arr, np.uint8)
    h, w = a.shape[0], a.shape[1]
    c = a.shape[2] if a.ndim == 3 else 1
    out = a.copy()
    lib = load()
    if lib is not None and _has_unfilter_med:
        lib.nbf_unfilter_med(_as_u8p(out), h, w, c)
        return out
    flat = out.reshape(h, w, c).astype(np.int16)
    for y in range(h):
        for x in range(w):
            left = flat[y, x - 1] if x else np.zeros(c, np.int16)
            up = flat[y - 1, x] if y else np.zeros(c, np.int16)
            ul = (flat[y - 1, x - 1] if (x and y)
                  else np.zeros(c, np.int16))
            mn = np.minimum(left, up)
            mx = np.maximum(left, up)
            pred = np.where(ul >= mx, mn,
                            np.where(ul <= mn, mx, left + up - ul))
            flat[y, x] = (flat[y, x] + pred) & 0xFF
    return flat.astype(np.uint8).reshape(a.shape)


def witness_popcounts(wit_rows: np.ndarray, wcnt: np.ndarray) -> np.ndarray:
    """Per-row popcount of the first wcnt[r] bits of each padded witness
    row ((rows, stride) u8) — the decode-side block change counts."""
    lib = load()
    wit_rows = np.ascontiguousarray(wit_rows, np.uint8)
    wcnt = np.ascontiguousarray(wcnt, np.int32)
    rows, stride = wit_rows.shape
    if lib is not None:
        out = np.empty(rows, np.int32)
        pi32 = ctypes.POINTER(ctypes.c_int32)
        lib.nbf_witness_popcounts(
            _as_u8p(wit_rows), rows, stride,
            wcnt.ctypes.data_as(pi32), out.ctypes.data_as(pi32))
        return out
    bits = np.unpackbits(wit_rows, axis=1)
    valid = np.arange(stride * 8)[None, :] < wcnt[:, None]
    return (bits * valid).sum(axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# Y4M probe
# ---------------------------------------------------------------------------

def huf_decode(data: bytes, n_bits: int, lengths: np.ndarray,
               codes: np.ndarray, rlc: int,
               n_out: int) -> Optional[np.ndarray]:
    """PIZ Huffman decode (utils/exr.py hot loop) — C++ when built,
    else None (caller runs the Python decoder, whose typed errors
    double as the malformed-input path)."""
    lib = load()
    if lib is None or not _has_huf or n_out <= 0:
        return None
    arr = (np.frombuffer(data, np.uint8) if data
           else np.zeros(1, np.uint8))
    lengths = np.ascontiguousarray(lengths, np.int32)
    codes = np.ascontiguousarray(codes, np.uint64)
    out = np.empty(n_out, np.uint16)
    rc = lib.nbf_huf_decode(
        _as_u8p(arr), len(data), n_bits,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        rlc,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n_out)
    return out if rc == 0 else None


def y4m_probe(data: bytes) -> Optional[dict]:
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(data[:4096], np.uint8)
    u32 = ctypes.c_uint32
    w, h, fn, fd, hl, cs = u32(), u32(), u32(), u32(), u32(), u32()
    rc = lib.nbf_y4m_probe(_as_u8p(buf), len(buf), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(fn),
                           ctypes.byref(fd), ctypes.byref(hl),
                           ctypes.byref(cs))
    if rc != 0:
        return None
    return {"width": w.value, "height": h.value,
            "fps": (fn.value, fd.value), "header_len": hl.value,
            "colorspace": cs.value}
