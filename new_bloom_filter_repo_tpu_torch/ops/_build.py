"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` a source, all started together, and linked into one shared
library with a plain C interface, at first use, into ``build/kernels/``
at the repository root (listed in ``.gitignore``).
The library's file name carries a hash of the sources and flags, so an
edited source builds anew and an unchanged one is reused.  The library
is loaded with ``ctypes``; every entry point takes device pointers as
``c_void_p``, sizes as ``c_int`` and the CUDA stream last, and returns
``cudaGetLastError()``.

Nothing here runs at import: the CPU tests import every module, on
machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(_PKG_DIR))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "kernels")
# Most frames one CTA of K1, K2, K5a or K5b walks: it sizes the kernels'
# shared frame arrays, and ops/blocked.frames_per_cta never asks for more.
GMAX = 16
# Most lanes past lane 0 that K1, K2, K5a and K5b run (k_lanes): the JAX
# package's k_bucket never gives more, so a frame whose floor(k) is
# larger probes lanes 0..32 in both packages.  Only a damaged stream has
# such a frame (a valid one has floor(k) <= 12); without the cap its k
# would set the kernels' loop count.  The entry points refuse more.
MAX_K_LANES = 32
# The global-motion search window is [-MOTION_RADIUS, MOTION_RADIUS]^2
# (K7 and K8 run a warp a dy, so 2R + 1 warps a CTA).
MOTION_RADIUS = 7
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DNBF_GMAX={GMAX}", f"-DNBF_MAX_K_LANES={MAX_K_LANES}",
              f"-DNBF_MOTION_RADIUS={MOTION_RADIUS}"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last nvcc run
build_log = ""                          # its output (ptxas register use)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # pointers..., ints..., stream
    "nbf_k1_encode": [_P] * 15 + [_I] * 6 + [_P],
    "nbf_k2_membership": [_P, _I] + [_P] * 11 + [_I] * 5 + [_P],
    "nbf_k3_expand_chain": [_P] * 7 + [_I] * 3 + [_P],
    "nbf_k4_expand": [_P] * 7 + [_I] * 3 + [_P],
    "nbf_k5a_encode": [_P] * 12 + [_I] * 6 + [_P],
    "nbf_k5b_membership": [_P, _I] + [_P] * 8 + [_I] * 5 + [_P],
    "nbf_k6_phase_a_diff": [_P] * 6 + [_I] * 5 + [_P],
    "nbf_k7_motion_counts": [_P] * 3 + [_I] * 7 + [_P],
    "nbf_k8_tile_motion_best": [_P] * 3 + [_I] * 8 + [_P],
}


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return path


def library_path() -> str:
    """Path of the built library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libnbf_kernels_{h.hexdigest()[:16]}.so")


def _run(procs, timeout: float = 600) -> list:
    """Wait for every ``(argv, Popen)``; return their outputs, or kill
    the rest and raise on the first that fails or outlives ``timeout``."""
    outs = []
    try:
        for argv, proc in procs:
            out, _ = proc.communicate(timeout=timeout)
            outs.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(argv)}\n{out}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def _start(argv):
    return argv, subprocess.Popen(argv, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)


def _compile(out: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith(".cu")]
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    tmp = os.path.join(work, "lib.so")
    objs = [os.path.join(work, os.path.basename(s) + ".o") for s in cu]
    t0 = time.perf_counter()
    try:
        logs = _run([_start([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s])
                     for s, o in zip(cu, objs)])
        logs += _run([_start([_nvcc(), *LINK_FLAGS, "-o", tmp, *objs])])
        build_log = "".join(logs)
        os.replace(tmp, out)          # atomic: readers never see a partial
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built from ``ops/csrc`` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not os.path.exists(out):
            _compile(out)
        lib = ctypes.CDLL(out)
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib
