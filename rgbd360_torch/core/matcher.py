"""Plane-graph matching: interpretation-tree search with unary/binary
constraints, plus closed-form pose-from-plane-correspondences.

Native replacement for mrpt::pbmap SubgraphMatcher + ConsistencyTest
(load-bearing externals of the reference — SURVEY.md §2.1 last row). The
constraint set and thresholds follow the reference's matcher INI
(config_files/configLocaliser_sphericalOdometry.ini:17-35) and its call
sites (include/RegisterRGBD360.h:276-341); the tree search maximizes matched
reference area like mrpt's calcAreaMatched. Exact mrpt semantics are not
recoverable (the fork's source is not in-tree), so fidelity is gated on
end-pose parity (SURVEY.md §7).

A copy of rgbd360_tpu/core/matcher.py (numpy only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from rgbd360_torch.core.pbmap import PbMap, Plane, bhattacharyya

DEFAULT_6DOF = 0
PLANAR_3DOF = 1
ODOMETRY_6DOF = 2
PLANAR_ODOMETRY_3DOF = 3

# The panorama/cloud frame has x pointing up (phi measured from the x axis,
# reference include/Frame360.h:589-592), so planar modes constrain motion
# about/along x.
UP_AXIS = np.array([1.0, 0.0, 0.0])


@dataclasses.dataclass
class MatcherConfig:
    """[unary]/[binary] thresholds (configLocaliser_sphericalOdometry.ini)."""

    min_planes_recognition: int = 3
    # unary
    dist_d: float = 0.5
    angle_deg: float = 50.0
    hue_threshold: float = 0.35
    elongation_threshold: float = 2.5
    area_threshold: float = 3.0
    # binary
    dist_threshold: float = 3.0
    angle_threshold_deg: float = 10.0
    height_threshold: float = 0.33
    cos_normal_parallel: float = 0.985

    @classmethod
    def from_ini(cls, path: str) -> "MatcherConfig":
        from rgbd360_torch.io.ini import parse_ini

        sec = parse_ini(path)
        u = sec.get("unary", {})
        b = sec.get("binary", {})
        g = sec.get("global", {})
        return cls(
            min_planes_recognition=int(float(g.get("min_planes_recognition", 3))),
            dist_d=float(u.get("dist_d", 0.5)),
            angle_deg=float(u.get("angle", 50.0)),
            hue_threshold=float(u.get("hue_threshold", 0.35)),
            elongation_threshold=float(u.get("elongation_threshold", 2.5)),
            area_threshold=float(u.get("area_threshold", 3.0)),
            dist_threshold=float(b.get("dist_threshold", 3.0)),
            angle_threshold_deg=float(b.get("angle_threshold", 10.0)),
            height_threshold=float(b.get("height_threshold", 0.33)),
            cos_normal_parallel=float(b.get("cos_normal_threshold", 0.985)),
        )


class SubgraphMatcher:
    """Interpretation-tree matcher over two plane subgraphs."""

    def __init__(self, config: Optional[MatcherConfig] = None):
        self.config = config or MatcherConfig()

    # -- constraints ---------------------------------------------------------
    def _unary(self, p1: Plane, p2: Plane, mode: int) -> bool:
        cfg = self.config
        a1, a2 = max(p1.area_hull, 1e-6), max(p2.area_hull, 1e-6)
        if max(a1, a2) / min(a1, a2) > cfg.area_threshold:
            return False
        e1, e2 = max(p1.elongation, 1.0), max(p2.elongation, 1.0)
        if max(e1, e2) / min(e1, e2) > cfg.elongation_threshold:
            return False
        if p1.hist_h is not None and p2.hist_h is not None:
            if bhattacharyya(p1.hist_h, p2.hist_h) < cfg.hue_threshold:
                return False
        if p1.label and p2.label and p1.label != p2.label:
            return False
        if mode in (ODOMETRY_6DOF, PLANAR_ODOMETRY_3DOF):
            # odometry: poses are close, so plane parameters barely move
            if abs(p1.d - p2.d) > cfg.dist_d:
                return False
            cos_ang = float(np.clip(p1.normal @ p2.normal, -1, 1))
            if math.degrees(math.acos(cos_ang)) > cfg.angle_deg:
                return False
        if mode in (PLANAR_3DOF, PLANAR_ODOMETRY_3DOF):
            # planar motion: the up-axis component of the normal is invariant
            if abs(float(p1.normal @ UP_AXIS) - float(p2.normal @ UP_AXIS)) > 0.1:
                return False
        return True

    def _binary(self, ri: Plane, rj: Plane, ti: Plane, tj: Plane, mode: int) -> bool:
        cfg = self.config
        # relative angle between the two planes must be preserved
        ang_r = math.degrees(math.acos(float(np.clip(ri.normal @ rj.normal, -1, 1))))
        ang_t = math.degrees(math.acos(float(np.clip(ti.normal @ tj.normal, -1, 1))))
        if abs(ang_r - ang_t) > cfg.angle_threshold_deg:
            return False
        # relative center distance preserved (ratio, per ini dist_threshold)
        d_r = float(np.linalg.norm(ri.center - rj.center))
        d_t = float(np.linalg.norm(ti.center - tj.center))
        lo, hi = min(d_r, d_t), max(d_r, d_t)
        if lo > 1e-6 and hi / max(lo, 1e-6) > cfg.dist_threshold and hi - lo > 0.5:
            return False
        # normal-projected offset: a rigid-motion invariant that is also
        # robust to view-dependent centroid sliding only when the planes are
        # near-parallel (the slide is then orthogonal to both normals) — the
        # reason the ini carries cos_normal_threshold
        if abs(ri.normal @ rj.normal) > cfg.cos_normal_parallel:
            off_r = abs(float(ri.normal @ (ri.center - rj.center)))
            off_t = abs(float(ti.normal @ (ti.center - tj.center)))
            if abs(off_r - off_t) > cfg.height_threshold:
                return False
        if mode in (PLANAR_3DOF, PLANAR_ODOMETRY_3DOF):
            # height difference along the up axis is invariant under planar motion
            h_r = float((ri.center - rj.center) @ UP_AXIS)
            h_t = float((ti.center - tj.center) @ UP_AXIS)
            if abs(h_r - h_t) > cfg.height_threshold:
                return False
        return True

    # -- search ----------------------------------------------------------------
    def compare_subgraphs(
        self,
        ref: PbMap,
        trg: PbMap,
        ref_idx: List[int],
        trg_idx: List[int],
        mode: int = DEFAULT_6DOF,
    ) -> Dict[int, int]:
        """Best ref->trg plane assignment maximizing matched reference area."""
        ref_planes = [ref.planes[i] for i in ref_idx]
        trg_planes = [trg.planes[j] for j in trg_idx]
        nr, nt = len(ref_planes), len(trg_planes)
        unary = np.zeros((nr, nt), bool)
        for i in range(nr):
            for j in range(nt):
                unary[i, j] = self._unary(ref_planes[i], trg_planes[j], mode)

        # order reference planes by area (largest first) for strong pruning
        order = sorted(range(nr), key=lambda i: -ref_planes[i].area_hull)
        areas = np.array([ref_planes[i].area_hull for i in order])
        suffix_area = np.concatenate([np.cumsum(areas[::-1])[::-1], [0.0]])

        best: Dict[int, int] = {}
        best_area = [0.0]

        def explore(k: int, assigned: List[Tuple[int, int]], used_t: set, area: float):
            if area + suffix_area[k] <= best_area[0]:
                return
            if k == nr:
                if area > best_area[0]:
                    best_area[0] = area
                    best.clear()
                    best.update({a: b for a, b in assigned})
                return
            i = order[k]
            pi = ref_planes[i]
            for j in range(nt):
                if j in used_t or not unary[i, j]:
                    continue
                pj = trg_planes[j]
                if all(
                    self._binary(pi, ref_planes[i2], pj, trg_planes[j2], mode)
                    for i2, j2 in assigned
                ):
                    assigned.append((i, j))
                    used_t.add(j)
                    explore(k + 1, assigned, used_t, area + pi.area_hull)
                    assigned.pop()
                    used_t.remove(j)
            explore(k + 1, assigned, used_t, area)  # skip ref plane i

        explore(0, [], set(), 0.0)
        # map back to PbMap plane ids
        return {ref_idx[i]: trg_idx[j] for i, j in best.items()}

    def calc_area_matched(self, ref: PbMap, match: Dict[int, int]) -> float:
        return float(sum(ref.planes[i].area_hull for i in match))


def estimate_pose_from_planes(
    ref: PbMap, trg: PbMap, match: Dict[int, int], mode: int = DEFAULT_6DOF
) -> Tuple[bool, np.ndarray, np.ndarray]:
    """Closed-form pose (trg as seen from ref) + 6x6 information matrix from
    matched planes — native ConsistencyTest::estimatePoseWithCovariance
    (called at reference include/RegisterRGBD360.h:320).

    Rotation: Kabsch on normal pairs weighted by matched area; translation:
    least squares on plane-offset differences. In the planar modes the motion
    is constrained to the ground plane (rotation about the up axis, zero
    vertical translation) — indoor scenes rarely observe the up direction
    from wall planes alone. Returns (ok, pose 4x4, info 6x6).
    """
    if len(match) < 3:
        return False, np.eye(4, dtype=np.float32), np.zeros((6, 6), np.float32)
    n_r = np.stack([ref.planes[i].normal for i in match])
    n_t = np.stack([trg.planes[j].normal for j in match.values()])
    d_r = np.array([ref.planes[i].d for i in match])
    d_t = np.array([trg.planes[j].d for j in match.values()])
    w = np.array(
        [min(ref.planes[i].area_hull, trg.planes[j].area_hull) for i, j in match.items()]
    )
    w = w / max(w.sum(), 1e-9)

    planar = mode in (PLANAR_3DOF, PLANAR_ODOMETRY_3DOF)
    A = (n_r * w[:, None]).T @ n_r
    if planar:
        # rotation about the up axis (x): 2D Kabsch on the (y,z) normal parts
        a = n_t[:, 1:]
        bv = n_r[:, 1:]
        cross = np.sum(w * (a[:, 0] * bv[:, 1] - a[:, 1] * bv[:, 0]))
        dot = np.sum(w * np.sum(a * bv, axis=1))
        theta = math.atan2(cross, dot)
        c, s = math.cos(theta), math.sin(theta)
        R = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
        A2 = A[1:, 1:]
        ev2 = np.linalg.eigvalsh(A2)
        if ev2[0] < 1e-6 * max(ev2[1], 1e-12):
            return False, np.eye(4, dtype=np.float32), np.zeros((6, 6), np.float32)
        b2 = (n_r[:, 1:] * (w * (d_t - d_r))[:, None]).sum(axis=0)
        t = np.zeros(3)
        t[1:] = np.linalg.solve(A2, b2)
    else:
        # rotation: maximize sum w_i (R n_t,i) . n_r,i
        M = (n_r * w[:, None]).T @ n_t
        U, S, Vt = np.linalg.svd(M)
        Dm = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
        R = U @ Dm @ Vt
        # observability: normals must span 3D
        ev = np.linalg.eigvalsh(A)
        if ev[0] < 1e-6 * max(ev[2], 1e-12):
            return False, np.eye(4, dtype=np.float32), np.zeros((6, 6), np.float32)
        b = (n_r * (w * (d_t - d_r))[:, None]).sum(axis=0)
        t = np.linalg.solve(A, b)

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.astype(np.float32)
    pose[:3, 3] = t.astype(np.float32)

    # information matrix: block [translation; rotation] from the plane
    # constraint Jacobians (t block: sum w n n^T; r block: sum w skew(Rn)^T skew(Rn))
    info = np.zeros((6, 6), np.float64)
    info[:3, :3] = A
    for k in range(len(n_r)):
        rn = R @ n_t[k]
        sk = np.array(
            [[0, -rn[2], rn[1]], [rn[2], 0, -rn[0]], [-rn[1], rn[0], 0]]
        )
        info[3:, 3:] += w[k] * (sk.T @ sk)
    return True, pose, info.astype(np.float32)
