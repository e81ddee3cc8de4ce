"""Laser (2D LIDAR) <-> RGB-D extrinsic calibration from plane-line
correspondences (reference include/CalibrateLaser.h:54-1081
CalibPairLaserKinect / ControlPlaneLines).

A laser scan line lying on a wall plane observed by the RGB-D sensor
constrains the extrinsic: the rotated line direction must be orthogonal to
the plane normal, and line points must satisfy the plane equation. The same
decoupled closed form as the camera-pair calibrator applies:
  rotation:  GN on n^T R l = 0 over all (plane n, line direction l) pairs
             (direction constraints only — with wall-only scenes whose
             normals are coplanar this can be rank-deficient, in which case
             calibrate_rotation returns None rather than a wrong answer);
  translation: LS on n^T t = d - n^T R p over the line centers p.
A copy of rgbd360_tpu/core/calibrate_laser.py (host numpy, no device work).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class PlaneLineCorrespondence:
    normal: np.ndarray  # plane normal in camera frame (unit)
    d: float  # plane offset: n.x = d for points on the plane
    line_dir: np.ndarray  # line direction in laser frame (unit)
    line_center: np.ndarray  # a point of the line in the laser frame


class CalibPairLaserKinect:
    def __init__(self):
        self.correspondences: List[PlaneLineCorrespondence] = []
        self.rt_estimated = np.eye(4)

    def add(self, normal, d, line_dir, line_center) -> None:
        self.correspondences.append(
            PlaneLineCorrespondence(
                np.asarray(normal, float) / np.linalg.norm(normal),
                float(d),
                np.asarray(line_dir, float) / np.linalg.norm(line_dir),
                np.asarray(line_center, float),
            )
        )

    def calibrate_rotation(self, iterations: int = 20) -> Optional[np.ndarray]:
        """Gauss-Newton on so(3) minimizing sum (n^T R l)^2 (line directions
        must lie inside their planes)."""
        if len(self.correspondences) < 3:
            return None
        R = self.rt_estimated[:3, :3].copy()
        for _ in range(iterations):
            H = np.zeros((3, 3))
            g = np.zeros(3)
            for c in self.correspondences:
                rl = R @ c.line_dir
                e = float(c.normal @ rl)
                # d e / d w = n^T d(R l)/dw = n^T (-[R l]x) = (R l x n)^T
                J = np.cross(rl, c.normal)
                H += np.outer(J, J)
                g += J * e
            ev = np.linalg.eigvalsh(H)
            if ev[0] < 1e-9 * max(ev[-1], 1e-12):
                return None
            w = np.linalg.solve(H + 1e-12 * np.eye(3), -g)
            th = np.linalg.norm(w)
            K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
            dR = np.eye(3) + (np.sin(th) / th) * K + ((1 - np.cos(th)) / th**2) * (K @ K) if th > 1e-12 else np.eye(3) + K
            R = dR @ R
            if th < 1e-12:
                break
        self.rt_estimated[:3, :3] = R
        return R

    def calibrate_translation(self) -> Optional[np.ndarray]:
        """LS on n^T (R p + t) = d for the line centers."""
        if len(self.correspondences) < 3:
            return None
        R = self.rt_estimated[:3, :3]
        H = np.zeros((3, 3))
        g = np.zeros(3)
        for c in self.correspondences:
            H += np.outer(c.normal, c.normal)
            g += c.normal * (c.d - float(c.normal @ (R @ c.line_center)))
        ev = np.linalg.eigvalsh(H)
        if ev[0] < 1e-9 * max(ev[-1], 1e-12):
            return None
        t = np.linalg.solve(H, g)
        self.rt_estimated[:3, 3] = t
        return t

    def calibrate(self) -> Optional[np.ndarray]:
        if self.calibrate_rotation() is None:
            return None
        if self.calibrate_translation() is None:
            return None
        return self.rt_estimated
