"""Point-cloud filters (reference include/FilterPointCloud.h:63-103):
pass-through box filter (x in [-2,1], y,z in [-4,4]) and voxel-grid
downsampling (leaf 0.05 m in the SLAM apps). Vectorized NumPy — these run on
visualization/ICP-prep paths, not in the hot loop.

A copy of rgbd360_tpu/ops/filter_cloud.py (host numpy; the port never
imports the JAX package).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

BOX_X = (-2.0, 1.0)
BOX_Y = (-4.0, 4.0)
BOX_Z = (-4.0, 4.0)


def filter_euclidean(
    xyz: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    box_x: Tuple[float, float] = BOX_X,
    box_y: Tuple[float, float] = BOX_Y,
    box_z: Tuple[float, float] = BOX_Z,
):
    """Pass-through box filter (reference :78-90)."""
    xyz = np.asarray(xyz).reshape(-1, 3)
    keep = (
        np.isfinite(xyz).all(axis=1)
        & (xyz[:, 0] >= box_x[0]) & (xyz[:, 0] <= box_x[1])
        & (xyz[:, 1] >= box_y[0]) & (xyz[:, 1] <= box_y[1])
        & (xyz[:, 2] >= box_z[0]) & (xyz[:, 2] <= box_z[1])
    )
    if rgb is not None:
        return xyz[keep], np.asarray(rgb).reshape(-1, 3)[keep]
    return xyz[keep]


def filter_voxel(
    xyz: np.ndarray, rgb: Optional[np.ndarray] = None, leaf: float = 0.05
):
    """Voxel-grid downsample: centroid (and mean color) per occupied voxel
    (reference :92-101, leaf sizes set at FilterPointCloud.h:63-70)."""
    xyz = np.asarray(xyz).reshape(-1, 3)
    finite = np.isfinite(xyz).all(axis=1)
    xyz = xyz[finite]
    if rgb is not None:
        rgb = np.asarray(rgb).reshape(-1, 3)[finite].astype(np.float64)
    if len(xyz) == 0:
        return (xyz, rgb) if rgb is not None else xyz
    keys = np.floor(xyz / leaf).astype(np.int64)
    # hash voxel coords to group
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.size, 3))
    np.add.at(sums, inverse, xyz)
    centroids = sums / counts[:, None]
    if rgb is not None:
        csums = np.zeros((counts.size, 3))
        np.add.at(csums, inverse, rgb)
        return centroids, (csums / counts[:, None]).astype(np.uint8)
    return centroids
