"""Trajectory output of the apps.

Counterpart of ``save_trajectory`` in rgbd360_tpu/utils/viz.py, copied; the
PCD/PLY writers, readers and viewers of that module come with the periphery
(ROADMAP queue 1, slice 7).
"""

from __future__ import annotations

import numpy as np


def save_trajectory(path: str, poses) -> None:
    """One 4x4 pose per 4 lines (reference Rt dumps, OdometryRGBD360.cpp:279)."""
    with open(path, "w") as f:
        for pose in poses:
            for row in np.asarray(pose):
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
