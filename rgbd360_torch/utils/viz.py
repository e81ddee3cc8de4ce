"""Artifact output of the apps and keyframes.

Copies of the writers of rgbd360_tpu/utils/viz.py (numpy only; the PCD,
PLY and PNG files are the same in both packages): ``save_png``,
``depth_to_u8``, ``save_sphere_images``, ``save_ply``, ``save_pcd``,
``load_pcd`` and ``save_trajectory``. A frame's panorama is read back from
its device first.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def host_array(x) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3:
        Image.fromarray(img.astype(np.uint8)).save(path)
    else:
        Image.fromarray(img.astype(np.uint8), mode="L").save(path)


def depth_to_u8(depth_mm: np.ndarray, max_mm: float = 6000.0) -> np.ndarray:
    return (np.clip(np.asarray(depth_mm, np.float32) / max_mm, 0, 1) * 255).astype(np.uint8)


def save_sphere_images(frame, out_dir: str, tag: str) -> None:
    """rgb_<tag>.png + depth_<tag>.png like the reference's SAVE_IMAGES path
    (Registration/OdometryRGBD360.cpp:157-163)."""
    os.makedirs(out_dir, exist_ok=True)
    rgb = host_array(frame.sphere_rgb)[..., ::-1]  # BGR -> RGB for PNG
    save_png(os.path.join(out_dir, f"rgb_{tag}.png"), rgb)
    save_png(os.path.join(out_dir, f"depth_{tag}.png"), depth_to_u8(host_array(frame.sphere_depth_mm)))


def save_ply(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None) -> None:
    """ASCII PLY point cloud (finite points only)."""
    xyz = np.asarray(xyz).reshape(-1, 3)
    keep = np.isfinite(xyz).all(axis=1)
    xyz = xyz[keep]
    colors = None
    if rgb is not None:
        colors = np.asarray(rgb).reshape(-1, 3)[keep].astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            np.savetxt(f, np.concatenate([xyz, colors], axis=1), fmt="%.4f %.4f %.4f %d %d %d")
        else:
            np.savetxt(f, xyz, fmt="%.4f")


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
