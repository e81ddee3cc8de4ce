"""Artifact output of the apps and keyframes.

Copies of ``save_trajectory``, ``save_pcd`` and ``load_pcd`` from
rgbd360_tpu/utils/viz.py (numpy only; the PCD files are the same format in
both packages). The PNG/PLY writers and viewers of that module come with the
periphery (ROADMAP queue 1, slice 7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_pcd(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
             organized_shape: Optional[tuple] = None) -> None:
    """ASCII PCD (the reference saves sphereCloud_%u.pcd, Frame360.h:321-330).
    NaN points are kept, and organized_shape=(H, W) writes an organized
    header (WIDTH W HEIGHT H) as PCL's savePCDFile does for the panorama
    cloud."""
    xyz = np.asarray(xyz).reshape(-1, 3)
    fields = "x y z" + (" rgb" if rgb is not None else "")
    n = len(xyz)
    if organized_shape is not None:
        hh, ww = organized_shape
        if hh * ww != n:
            raise ValueError(f"organized_shape {organized_shape} does not hold {n} points")
    else:
        hh, ww = 1, n
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        f.write(f"FIELDS {fields}\n")
        if rgb is not None:
            f.write("SIZE 4 4 4 4\nTYPE F F F U\nCOUNT 1 1 1 1\n")
        else:
            f.write("SIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        f.write(f"WIDTH {ww}\nHEIGHT {hh}\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n")
        if rgb is not None:
            packed = np.asarray(rgb).reshape(-1, 3).astype(np.uint32)
            packed = (packed[:, 0] << 16) | (packed[:, 1] << 8) | packed[:, 2]
            np.savetxt(f, np.concatenate([xyz, packed[:, None].astype(np.float64)], axis=1), fmt="%.4f %.4f %.4f %d")
        else:
            np.savetxt(f, xyz, fmt="%.4f")


def load_pcd(path: str):
    """Read the ASCII PCD written by save_pcd (x y z [packed rgb]).
    Returns (xyz (N,3) f32, rgb (N,3) u8 or None)."""
    with open(path) as f:
        fields = []
        n = 0
        for line in f:
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("POINTS"):
                n = int(line.split()[1])
            elif line.startswith("DATA"):
                if line.split()[1] != "ascii":
                    raise ValueError("only ascii PCD supported")
                break
        data = np.loadtxt(f, dtype=np.float64, max_rows=n)
    data = data.reshape(-1, len(fields))
    xyz = data[:, :3].astype(np.float32)
    rgb = None
    if "rgb" in fields:
        packed = data[:, 3].astype(np.uint32)
        rgb = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], axis=-1).astype(np.uint8)
    return xyz, rgb


def save_trajectory(path: str, poses) -> None:
    """One 4x4 pose per 4 lines (reference Rt dumps, OdometryRGBD360.cpp:279)."""
    with open(path, "w") as f:
        for pose in poses:
            for row in np.asarray(pose):
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
