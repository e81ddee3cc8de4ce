"""The reference's panoramas, made from the raw files alone.

Reads a capture (the boost archive of Frame360.h:231-266) and the rig's
extrinsics (Calibration/Extrinsics/Rt_0N.txt) with numpy and stitches the
1920 x 320 panorama with the frozen stitch of stitch.py (Frame360.h:
386-405): the stitch reads the raw u16 depth, as the reference's does.
Imports nothing of the program.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from . import stitch
from .image import gray_f32

_DTYPES = {0: np.uint8, 2: np.uint16}


def _read_mat(buf: bytes, pos: int):
    cols, rows, elem_size, elem_type = struct.unpack_from("<iiQQ", buf, pos)
    pos += 24
    nbytes = cols * rows * elem_size
    channels = (elem_type >> 3) + 1
    if rows == 0 or cols == 0:
        return None, pos
    arr = np.frombuffer(buf, _DTYPES[elem_type & 7], count=nbytes // np.dtype(_DTYPES[elem_type & 7]).itemsize,
                        offset=pos)
    arr = arr.reshape((rows, cols, channels) if channels > 1 else (rows, cols))
    return arr, pos + nbytes


def read_capture(path: str):
    """(rgb (8, 240, 320, 3) u8 BGR, depth (8, 240, 320) u16 mm) of a .bin."""
    with open(path, "rb") as f:
        buf = f.read()
    (sig_len,) = struct.unpack_from("<Q", buf, 0)
    if buf[8:8 + sig_len] != b"serialization::archive":
        raise ValueError(f"{path}: not a boost binary archive")
    pos = 8 + sig_len + 2 + 4 + 9  # version, primitive sizes, class metadata
    rgbs, depths = [], []
    for _ in range(8):
        rgb, pos = _read_mat(buf, pos)
        depth, pos = _read_mat(buf, pos)
        rgbs.append(rgb)
        depths.append(depth)
    return np.stack(rgbs), np.stack(depths)


def camera_matrix() -> np.ndarray:
    """QVGA pinhole intrinsics (Calib360.h:74-77)."""
    return np.array([[262.5, 0.0, 159.5], [0.0, 262.5, 119.5], [0.0, 0.0, 1.0]], np.float32)


def extrinsics_inv(calib_root: str) -> np.ndarray:
    """(8, 4, 4) f32 inverse sensor poses, as Calib360.h:122-131 loads them:
    the f64 file rounded to f32, inverted in f64, rounded to f32."""
    out = np.zeros((8, 4, 4), np.float32)
    for s in range(8):
        rt = np.loadtxt(os.path.join(calib_root, "Calibration", "Extrinsics", f"Rt_0{s + 1}.txt"),
                        dtype=np.float64).astype(np.float32)
        out[s] = np.linalg.inv(rt.astype(np.float64)).astype(np.float32)
    return out


class Stitcher:
    """Panoramas of one calibration root on ``device``."""

    def __init__(self, calib_root: str, device):
        rt_inv = torch.from_numpy(extrinsics_inv(calib_root)).to(device)
        cam = torch.from_numpy(camera_matrix()).to(device)
        self.device = torch.device(device)
        self.maps = stitch.stitch_maps(rt_inv, cam)

    def panorama(self, path: str):
        """(sphere_rgb (320, 1920, 3) u8, sphere_depth_mm (320, 1920) u16)."""
        rgb, depth = read_capture(path)
        rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)
        depth_t = torch.from_numpy(np.ascontiguousarray(depth)).to(self.device)
        return stitch.stitch_with_maps(rgb_t, depth_t, self.maps)

    def aligner_input(self, path: str):
        """(gray (320, 1920) f32 in [0, 1], depth (320, 1920) f32 metres)."""
        rgb, depth_mm = self.panorama(path)
        return gray_f32(rgb), depth_mm.to(torch.float32) * 0.001
