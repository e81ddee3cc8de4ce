"""Shared CLI plumbing of the port's apps.

Counterpart of rgbd360_tpu/apps/common.py. The calibration root has no
built-in default here: pass it (--calib-root) or set RGBD360_REFERENCE. The
entry points run on the card unless a device is named (device.py).
"""

from __future__ import annotations

import os

import numpy as np

from rgbd360_torch.io.calib import Calib360

DEFAULT_DATA_ROOT = os.environ.get("RGBD360_REFERENCE")


def _root(root: str = None) -> str:
    root = root or DEFAULT_DATA_ROOT
    if root is None:
        raise ValueError("no calibration root: pass --calib-root or set RGBD360_REFERENCE")
    return root


def load_calib(root: str = None) -> Calib360:
    return Calib360.load(_root(root))


def default_matcher_config(root: str = None) -> str:
    """The PbMap matcher .ini of a data root (common.py:18)."""
    return os.path.join(_root(root), "config_files", "configLocaliser_sphericalOdometry.ini")


def rot_offset() -> np.ndarray:
    """157.5 deg sphere-vs-cloud frame offset (OdometryRGBD360.cpp:137-139)."""
    a = np.deg2rad(157.5)
    m = np.eye(4, dtype=np.float64)
    m[1, 1] = m[2, 2] = np.cos(a)
    m[1, 2] = np.sin(a)
    m[2, 1] = -np.sin(a)
    return m


def sequence_files(path: str, first: int, sample: int):
    """Yield (frame_number, file) over sphere_images_%d.bin like the apps'
    fexists loop (OdometryRGBD360.cpp:130-141)."""
    n = first
    while True:
        f = os.path.join(path, f"sphere_images_{n}.bin")
        if not os.path.exists(f):
            return
        yield n, f
        n += sample


def sequence_frames(calib, path: str, first: int, sample: int, device=None, defer_device: bool = False):
    """Yield (frame_number, Frame360 on ``device``, the card by default)
    over a dataset, with disk IO + archive parsing of upcoming frames
    prefetched on native C++ threads when the toolchain allows
    (io/native_loader.py), else read by the Python reader.

    defer_device=True yields raw-only frames (no undistort/stitch):
    planes_pipeline then runs the whole per-frame device pipeline in one
    call (Frame360.build_device_fused). Leave False for consumers that read
    the panoramas without the planes pipeline."""
    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.io.native_loader import iter_frames
    from rgbd360_torch.utils.timing import stage

    numbered = list(sequence_files(path, first, sample))
    raws = iter_frames([f for _, f in numbered])
    for frame_no, _f in numbered:
        frame = Frame360(calib, frame_no, device)
        with stage("Frame360.loadFrame", sync=frame._sync):
            frame.set_raw(next(raws))
        if defer_device:
            # explicit marker: planes_pipeline routes ONLY frames tagged here
            # through the fused device pipeline; attribute sniffing would
            # also match frames whose depth must not be CLAMS-undistorted
            frame._deferred_build = True
        else:
            frame.undistort()
            frame.stitch_spherical_image()
        yield frame_no, frame
