"""The ideal rig of the construction specs.

Counterpart of ``construction_specs`` in rgbd360_tpu/core/calibrator.py
(copied alone; the extrinsic calibration suite of that module is ported
with the periphery, ROADMAP queue 1 slice 7).
"""

from __future__ import annotations

import numpy as np

NUM_SENSORS = 8


def construction_specs() -> np.ndarray:
    """Ideal rig (reference loadConstructionSpecs, Calibrator.h:763-776):
    Rt_0 is identity with t = (0, 0, 0.055) — the theoretical distance from
    the first sensor to the device centre — and each subsequent pose is a
    45 deg turn about the vertical (x) axis of the previous,
    Rt_s = turn45 @ Rt_{s-1}, so the sensors lie on a 0.055 m ring in the
    y-z plane (matches the shipped ConstructionSpecs/Rt_0*.txt)."""
    rts = np.tile(np.eye(4, dtype=np.float64), (NUM_SENSORS, 1, 1))
    rts[0, 2, 3] = 0.055
    a = np.deg2rad(45.0)
    c, si = np.cos(a), np.sin(a)
    turn45 = np.eye(4)
    turn45[1, 1] = turn45[2, 2] = c
    turn45[1, 2] = -si
    turn45[2, 1] = si
    for s in range(1, NUM_SENSORS):
        rts[s] = turn45 @ rts[s - 1]
    return rts
