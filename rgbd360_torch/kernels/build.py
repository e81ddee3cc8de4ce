"""Build and load the port's CUDA kernels (no JAX counterpart: the JAX
package's Pallas kernels compile inside jit).

``csrc/*.cu`` compile with nvcc into one shared library with a plain C
interface, loaded with ctypes. The library lands in ``rgbd360_torch/_build/``
(listed in .gitignore) under a name keyed by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once.
Nothing here runs at import: the first wrapper launch on a CUDA tensor
builds. A failed build raises; nothing falls back to the plain version.

Flags are fixed and exact: no --use_fast_math, -ftz, -prec-div=false or
-fmad changes (the mean row policy needs IEEE f32 division, and the
gradients carry denormals).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None  # wall time of the nvcc run in this process, or None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _bind(lib) -> None:
    fn = lib.rgbd360_warp_gather
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu if no library of this source hash exists. Returns
    the library path."""
    global BUILD_SECONDS
    srcs = _sources()
    out = os.path.join(BUILD_DIR, f"librgbd360_kernels_{_key(srcs)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) + ["-o", tmp] + srcs
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    return out


def load_library(verbose: bool = False):
    """Build once per process if needed, load, bind and return the library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build(verbose=verbose))
            _bind(lib)
            _lib = lib
    return _lib
