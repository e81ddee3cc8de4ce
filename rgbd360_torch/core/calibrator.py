"""Extrinsic calibration of the 8-sensor rig from matched planes
(reference include/Calibrator.h: ControlPlanes :42-171, PairCalibrator
:373-760, Calibrator :763-1199).

A copy of rgbd360_tpu/core/calibrator.py: host float64 numpy, no device
work (the planes it is fed come from the device program of the plane
layer). Correspondence rows follow the reference layout: [n1(3), d1, n2(3),
d2] for a plane observed by two sensors. The decoupled closed form:
  rotation:     Kabsch on sum n2 n1^T with a conditioning gate
                (max/min singular value, reference :419-436)
  translation:  least squares on n1 . t = d2 - d1 (reference :644-699)
Construction-spec initialization: each sensor pose is a 45 deg turn of the
previous about the rig axis (reference :763-776).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from rgbd360_torch.config import default_params

CONDITIONING_GATE = 100.0  # reference Calibrator.h:422
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


@dataclasses.dataclass
class PlaneCorrespondences:
    """ControlPlanes: plane matches between sensor pairs
    (reference Calibrator.h:42-171)."""

    rows: Dict[tuple, List[np.ndarray]] = dataclasses.field(default_factory=dict)

    def add(self, s1: int, s2: int, n1, d1, n2, d2) -> None:
        key = (min(s1, s2), max(s1, s2))
        if s1 > s2:
            n1, d1, n2, d2 = n2, d2, n1, d1
        self.rows.setdefault(key, []).append(
            np.concatenate([np.asarray(n1, float), [float(d1)], np.asarray(n2, float), [float(d2)]])
        )

    def matrix(self, s1: int, s2: int) -> np.ndarray:
        key = (min(s1, s2), max(s1, s2))
        rows = self.rows.get(key, [])
        return np.stack(rows) if rows else np.zeros((0, 8))

    def conditioning(self, s1: int, s2: int) -> float:
        """max/min singular value of the normal covariance
        (reference calcConditioning, Calibrator.h:1190-1199)."""
        m = self.matrix(s1, s2)
        if len(m) < 3:
            return np.inf
        cov = m[:, :3].T @ m[:, :3]
        sv = np.linalg.svd(cov, compute_uv=False)
        return float(sv[0] / max(sv[-1], 1e-12))


class PairCalibrator:
    """Relative pose of sensor 2 wrt sensor 1 from plane matches."""

    def __init__(self):
        self.rt_estimated = np.eye(4)
        self.correspondences = np.zeros((0, 8))

    def set_init_rt(self, rt: np.ndarray) -> None:
        self.rt_estimated = np.asarray(rt, np.float64).copy()

    def calibrate_rotation(self) -> Optional[np.ndarray]:
        """Closed-form SVD rotation (reference Calibrator.h:373-439)."""
        c = self.correspondences
        if len(c) < 3:
            return None
        cov = np.zeros((3, 3))
        for row in c:
            cov += np.outer(row[4:7], row[:3])  # n2 n1^T
        U, S, Vt = np.linalg.svd(cov)
        if S[0] / max(S[-1], 1e-12) > CONDITIONING_GATE:
            return None
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            R = Vt.T @ np.diag([1.0, 1.0, -1.0]) @ U.T
        self.rt_estimated[:3, :3] = R
        return R

    def calibrate_translation(self) -> Optional[np.ndarray]:
        """LS translation from plane offsets (reference Calibrator.h:644-699)."""
        c = self.correspondences
        if len(c) < 3:
            return None
        H = np.zeros((3, 3))
        g = np.zeros(3)
        for row in c:
            n1 = row[:3]
            H += np.outer(n1, n1)
            g += n1 * (row[7] - row[3])  # d2 - d1
        sv = np.linalg.svd(H, compute_uv=False)
        if sv[0] / max(sv[-1], 1e-12) > default_params.threshold_conditioning:
            return None
        t = np.linalg.solve(H, g)
        self.rt_estimated[:3, 3] = t
        return t

    def calibrate_pair(self) -> Optional[np.ndarray]:
        """CalibratePair = rotation then translation (reference :701-760)."""
        if self.calibrate_rotation() is None:
            return None
        if self.calibrate_translation() is None:
            return None
        return self.rt_estimated


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], float)


def _exp_so3(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    W = _skew(w)
    if theta < 1e-12:
        return np.eye(3) + W + 0.5 * W @ W
    return (
        np.eye(3)
        + np.sin(theta) / theta * W
        + (1.0 - np.cos(theta)) / theta**2 * W @ W
    )


class Calibrator:
    """Joint 8-sensor rig calibration over *all* observed sensor pairs
    (including the 7<->0 ring wraparound), seeded from the construction
    specs (reference Calibrator.h:871-1065 CalibrateRotation — a 21-DoF
    Gauss-Newton with sensor 0's pose fixed — and :1067-1180
    CalibrateTranslation — one 21x21 least-squares solve + recentering).

    Correspondence d convention is mrpt pbmap's (d = -normal . center), for
    which d_obs = d_world + n_world . t_sensor — the convention under which
    the reference translation system n_i.t_i - n_j.t_j = d_i - d_j is exact.
    """

    MAX_ITERATIONS = 10  # reference :888-891
    EPSILON_TRANSF = 1e-5
    CONVERGENCE_ERROR = 1e-6

    def __init__(self, correspondences: PlaneCorrespondences):
        self.corresp = correspondences
        self.rt = construction_specs()
        self.conditioning = 0.0

    # -- error metrics (reference calcCorrespRotError :779-806) ---------------
    def rotation_error2(self, rt: Optional[np.ndarray] = None) -> float:
        rt = self.rt if rt is None else rt
        acc = 0.0
        for (i, j), rows in self.corresp.rows.items():
            for row in rows:
                n_i = rt[i][:3, :3] @ row[:3]
                n_j = rt[j][:3, :3] @ row[4:7]
                acc += float(np.dot(n_i - n_j, n_i - n_j))
        return acc

    def translation_error2(self, rt: Optional[np.ndarray] = None) -> float:
        rt = self.rt if rt is None else rt
        acc = 0.0
        for (i, j), rows in self.corresp.rows.items():
            for row in rows:
                n_i = rt[i][:3, :3] @ row[:3]
                n_j = rt[j][:3, :3] @ row[4:7]
                r = (row[3] - row[7]) - (
                    np.dot(n_i, rt[i][:3, 3]) - np.dot(n_j, rt[j][:3, 3])
                )
                acc += float(r * r)
        return acc

    @staticmethod
    def _conditioning21(H: np.ndarray) -> float:
        sv = np.linalg.svd(H, compute_uv=False)
        return float(sv[0] / max(sv[-1], 1e-30))

    # -- the joint solves -------------------------------------------------------
    def calibrate_rotation(self) -> np.ndarray:
        """21-DoF Gauss-Newton on the seven free sensor rotations
        (reference CalibrateRotation, Calibrator.h:871-1065): residual per
        control plane is n_i - n_j in world frame, Jacobians skew(-n_i) /
        skew(n_j); a step is accepted only if the total rotation error drops;
        afterwards the whole rig is rotated so the mean sensor X axis matches
        the vertical (:1025-1062)."""
        it, increment, diff_error = 0, 1000.0, 1000.0
        while (
            it < self.MAX_ITERATIONS
            and increment > self.EPSILON_TRANSF
            and diff_error > self.CONVERGENCE_ERROR
        ):
            H = np.zeros((21, 21))
            g = np.zeros(21)
            for (i, j), rows in self.corresp.rows.items():
                bi, bj = 3 * (i - 1), 3 * (j - 1)
                for row in rows:
                    n_i = self.rt[i][:3, :3] @ row[:3]
                    n_j = self.rt[j][:3, :3] @ row[4:7]
                    J_i = _skew(-n_i)
                    J_j = _skew(n_j)
                    err = n_i - n_j
                    if i != 0:  # sensor 0 fixed
                        H[bi : bi + 3, bi : bi + 3] += J_i.T @ J_i
                        g[bi : bi + 3] += J_i.T @ err
                        H[bi : bi + 3, bj : bj + 3] += J_i.T @ J_j
                    H[bj : bj + 3, bj : bj + 3] += J_j.T @ J_j
                    g[bj : bj + 3] += J_j.T @ err
                if i != 0:
                    H[bj : bj + 3, bi : bi + 3] = H[bi : bi + 3, bj : bj + 3].T

            self.conditioning = self._conditioning21(H)
            if self.conditioning > default_params.threshold_conditioning:
                break
            update = -np.linalg.solve(H, g)

            rt_tmp = self.rt.copy()
            for s in range(1, NUM_SENSORS):
                w = update[3 * s - 3 : 3 * s]
                rt_tmp[s, :3, :3] = _exp_so3(w) @ self.rt[s, :3, :3]
            err_old = self.rotation_error2(self.rt)
            err_new = self.rotation_error2(rt_tmp)
            if err_new < err_old:
                self.rt = rt_tmp
            increment = float(update @ update)
            diff_error = err_old - err_new
            it += 1

        # align the rig's mean X axis with the vertical (reference :1025-1062)
        Hr = np.zeros((3, 3))
        gr = np.zeros(3)
        x_axis = np.array([1.0, 0.0, 0.0])
        for s in range(NUM_SENSORS):
            x_pose = self.rt[s][:3, 0]
            err = np.cross(x_axis, x_pose)
            J = -_skew(x_axis) @ _skew(x_pose)
            Hr += J.T @ J
            gr += J.T @ err
        # least squares, not solve: when the rig's X axes already coincide
        # with the vertical (synthetic rigs, converged calibrations) the
        # residual is zero and Hr is exactly singular — the reference's
        # Eigen .inverse() silently produces garbage there (:1035); the
        # minimum-norm solution is the well-defined limit (no rotation)
        manifold = -np.linalg.lstsq(Hr, gr, rcond=None)[0]
        manifold[0] = 0.0  # the turn about X itself is gauge (:1046)
        rot = _exp_so3(manifold)
        for s in range(NUM_SENSORS):
            self.rt[s, :3, :3] = rot @ self.rt[s, :3, :3]
        return self.rt

    def calibrate_translation(self) -> np.ndarray:
        """21x21 least squares over all pairs: n_i.t_i - n_j.t_j = d_i - d_j
        with sensor 0 fixed, then recentre the device (reference
        CalibrateTranslation, Calibrator.h:1067-1180)."""
        H = np.zeros((21, 21))
        g = np.zeros(21)
        for (i, j), rows in self.corresp.rows.items():
            bi, bj = 3 * (i - 1), 3 * (j - 1)
            for row in rows:
                n_i = self.rt[i][:3, :3] @ row[:3]
                n_j = self.rt[j][:3, :3] @ row[4:7]
                trans_error = row[3] - row[7]  # d_i - d_j
                if i != 0:
                    H[bi : bi + 3, bi : bi + 3] += np.outer(n_i, n_i)
                    g[bi : bi + 3] += -n_i * trans_error
                    H[bi : bi + 3, bj : bj + 3] += -np.outer(n_i, n_j)
                H[bj : bj + 3, bj : bj + 3] += np.outer(n_j, n_j)
                g[bj : bj + 3] += n_j * trans_error
            if i != 0:
                H[bj : bj + 3, bi : bi + 3] = H[bi : bi + 3, bj : bj + 3].T

        self.conditioning = self._conditioning21(H)
        if self.conditioning < default_params.threshold_conditioning:
            update = -np.linalg.solve(H, g)
            center = update.reshape(7, 3).sum(axis=0) / NUM_SENSORS  # (:1160-1163)
            self.rt[0, :3, 3] = -center
            for s in range(1, NUM_SENSORS):
                self.rt[s, :3, 3] = update[3 * s - 3 : 3 * s] - center
        return self.rt

    def calibrate(self) -> np.ndarray:
        """Calibrate() = CalibrateRotation + CalibrateTranslation
        (reference Calibrator.h:1182-1186)."""
        self.calibrate_rotation()
        return self.calibrate_translation()

    def calibrate_chained(self) -> np.ndarray:
        """Adjacent-pair chaining (the round-1 fallback, kept for comparison:
        cross-pair constraints are discarded and error accumulates around the
        ring — the joint solve above supersedes it)."""
        rel = [np.eye(4) for _ in range(NUM_SENSORS)]
        for s in range(1, NUM_SENSORS):
            pair = PairCalibrator()
            pair.correspondences = self.corresp.matrix(s - 1, s)
            init = np.linalg.inv(self.rt[s - 1]) @ self.rt[s]
            pair.set_init_rt(init)
            est = pair.calibrate_pair()
            rel[s] = est if est is not None else init
        for s in range(1, NUM_SENSORS):
            self.rt[s] = self.rt[s - 1] @ rel[s]
        return self.rt
