"""The gaps the correctness checks compare, each a worst case over a sample."""

from __future__ import annotations

import numpy as np


def pose_gap(a, b):
    """(translation gap in mm, rotation gap in degrees) between two 4 x 4 poses."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    t_mm = float(np.linalg.norm(a[:3, 3] - b[:3, 3])) * 1000.0
    # the chord form: exact at 0 where the arccos of the trace is not
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2.0 * np.sqrt(2.0))
    return t_mm, float(np.degrees(2.0 * np.arcsin(min(chord, 1.0))))


def rel_gap(a: float, b: float) -> float:
    """|a - b| relative to |b|, with a floor of 1e-6 on the scale."""
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)


def iter_gap(a, b) -> float:
    """Gauss-Newton iterations by which two runs differ, summed over the
    pyramid's levels."""
    return float(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)).sum())


def absolute_trajectory_error(trajectory, ground_truth) -> float:
    """RMS translation error (m) of the trajectory against the ground truth,
    both expressed relative to their first pose (the SLAM apps start at the
    identity). Frozen from tools/synthetic_rig.py."""
    est, true = np.asarray(trajectory, np.float64), np.asarray(ground_truth, np.float64)
    true = np.linalg.inv(true[0]) @ true
    est = np.linalg.inv(est[0]) @ est
    return float(np.sqrt(np.mean(np.sum((est[:, :3, 3] - true[:, :3, 3]) ** 2, axis=1))))


class Worst:
    """The largest of each gap seen, by name: the names are the limits a
    cell's workload file gives, and a gap it does not name is not kept. A
    named gap with no sample reads inf, and so does any non-finite value: a
    comparison that found nothing to compare is not a pass."""

    def __init__(self, *names):
        self.seen = {n: None for n in names}

    def add(self, name: str, value: float) -> None:
        if name not in self.seen:
            return
        value = float(value)
        if not np.isfinite(value):
            value = float("inf")
        old = self.seen[name]
        self.seen[name] = value if old is None else max(old, value)

    @property
    def values(self) -> dict:
        return {n: (float("inf") if v is None else v) for n, v in self.seen.items()}
