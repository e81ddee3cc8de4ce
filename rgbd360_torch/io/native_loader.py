"""ctypes binding for the native C++ frame loader + threaded prefetcher
(io/native/frame_loader.cpp) — the data-loader runtime component the
reference implements in C++ (Frame360::loadFrame, include/Frame360.h:231-266,
there parallelized with 8 OpenMP threads per frame; here parallelized
*across* frames so sequence apps overlap disk IO + parsing with device
compute). A copy of rgbd360_tpu/io/native_loader.py.

The shared library is compiled on demand with g++ into a per-source-hash
cache inside the checkout (rgbd360_torch/_build/native, listed in
.gitignore). If the toolchain or compiled library is unavailable, callers
read through the pure Python reader (io/boost_archive.py), which stays the
reference implementation: both are host readers of the same bytes, so this
is no device fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from rgbd360_torch.io.boost_archive import RawFrame360, read_frame360_bin

_SRC = os.path.join(os.path.dirname(__file__), "native", "frame_loader.cpp")
_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build", "native")

_ERRORS = {
    1: "cannot open file",
    2: "truncated archive",
    3: "bad boost archive signature",
    4: "unexpected image shape",
    5: "unexpected cv type",
    6: "prefetcher exhausted",
}

_lib = None
_lib_lock = threading.Lock()
_build_failed = False

H, W = 240, 320  # QVGA, the reference wire format (Calib360.h:70-77)


def _probe_dims(path: str):
    """(rows, cols) of the first image record, or None if unreadable —
    datasets at other resolutions fall back to the Python reader, which
    parses dimensions per record."""
    import struct

    try:
        with open(path, "rb") as f:
            head = f.read(64)
        (sig_len,) = struct.unpack_from("<Q", head, 0)
        off = 8 + sig_len + 2 + 4 + 9  # signature, version, sizes, metadata
        cols, rows = struct.unpack_from("<ii", head, off)
        return rows, cols
    except (OSError, struct.error):
        return None


def _build_library() -> Optional[str]:
    """Compile frame_loader.cpp into the cache; returns the .so path or None."""
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return None
    so_path = os.path.join(_CACHE_DIR, f"frame_loader_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    except (subprocess.SubprocessError, OSError):
        return None
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return so_path


def _get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        so_path = _build_library()
        if so_path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(so_path)
        lib.rgbd360_parse_frame.restype = ctypes.c_int
        lib.rgbd360_parse_frame.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rgbd360_prefetcher_create.restype = ctypes.c_void_p
        lib.rgbd360_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.rgbd360_prefetcher_next.restype = ctypes.c_int
        lib.rgbd360_prefetcher_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rgbd360_prefetcher_destroy.restype = None
        lib.rgbd360_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library compiled (g++ present) and loaded."""
    return _get_lib() is not None


def parse_frame_native(path: str, h: int = H, w: int = W) -> RawFrame360:
    """Parse one .bin through the C++ loader (raises on malformed input or
    when the library is unavailable)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable (g++ build failed)")
    rgb = np.empty((8, h, w, 3), np.uint8)
    depth = np.empty((8, h, w), np.uint16)
    ts = ctypes.c_uint64(0)
    rc = lib.rgbd360_parse_frame(
        path.encode(), h, w,
        rgb.ctypes.data_as(ctypes.c_void_p),
        depth.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(ts),
    )
    if rc != 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, f'error {rc}')}")
    return RawFrame360(rgb=rgb, depth=depth, timestamp=int(ts.value))


class FramePrefetcher:
    """In-order threaded prefetch over a list of .bin paths. Iterate to get
    RawFrame360s; IO + parsing of upcoming frames proceeds on C++ threads
    while the consumer computes."""

    def __init__(
        self,
        paths: Sequence[str],
        threads: int = 2,
        max_ahead: int = 4,
        h: int = H,
        w: int = W,
    ):
        self._paths = [str(p) for p in paths]
        self._h, self._w = h, w
        self._lib = _get_lib()
        if self._lib is None:
            raise RuntimeError("native loader unavailable (g++ build failed)")
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths]
        )
        self._handle = self._lib.rgbd360_prefetcher_create(
            arr, len(self._paths), h, w, threads, max_ahead
        )
        self._delivered = 0

    def __iter__(self) -> Iterator[RawFrame360]:
        return self

    def __next__(self) -> RawFrame360:
        if self._handle is None or self._delivered >= len(self._paths):
            raise StopIteration
        rgb = np.empty((8, self._h, self._w, 3), np.uint8)
        depth = np.empty((8, self._h, self._w), np.uint16)
        ts = ctypes.c_uint64(0)
        rc = self._lib.rgbd360_prefetcher_next(
            self._handle,
            rgb.ctypes.data_as(ctypes.c_void_p),
            depth.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(ts),
        )
        self._delivered += 1
        if rc == 6:
            raise StopIteration
        if rc != 0:
            path = self._paths[self._delivered - 1]
            raise ValueError(f"{path}: {_ERRORS.get(rc, f'error {rc}')}")
        return RawFrame360(rgb=rgb, depth=depth, timestamp=int(ts.value))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.rgbd360_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def iter_frames(paths: Sequence[str], threads: int = 2, max_ahead: int = 4):
    """Yield RawFrame360 for each path, through the C++ prefetcher when the
    toolchain allows, else through the Python reader. Image dimensions come
    from the first file's header so non-QVGA datasets work on both paths
    (mixed-resolution datasets fall back to the per-record Python reader)."""
    paths = [str(p) for p in paths]
    dims = _probe_dims(paths[0]) if paths else None
    if available() and dims is not None:
        pf = FramePrefetcher(
            paths, threads=threads, max_ahead=max_ahead, h=dims[0], w=dims[1]
        )
        try:
            for raw in pf:
                yield raw
            return
        except ValueError as e:
            # e.g. a resolution change mid-dataset: finish via the Python
            # reader, which parses dimensions per record. Logged so a native
            # parser regression on uniform datasets is visible, not silently
            # papered over.
            print(f"[native_loader] native parse failed mid-stream ({e}); "
                  f"falling back to the Python reader")
            delivered = pf._delivered
            pf.close()
            for p in paths[delivered - 1 :]:
                yield read_frame360_bin(p)
            return
        finally:
            pf.close()
    for p in paths:
        yield read_frame360_bin(p)
