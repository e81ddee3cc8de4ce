"""Frozen copy of rgbd360_torch/core/graph_optimizer.py for the benchmark's reference;
imports nothing of the program. The original's notes follow.

Copy of rgbd360_tpu/core/graph_optimizer.py (numpy only): the port keeps
its own copy because importing any rgbd360_tpu module imports jax.

Native pose-graph optimizer — replaces the reference's g2o backend
(include/GraphOptimizer.h:84-286: addVertex/addEdge/optimizeGraph/getPoses/
saveGraph; 6-DoF SE(3), Levenberg-Marquardt, dense solver, 10 iterations,
vertex 0 fixed).

The graphs here are 10^2-10^3 vertices (SURVEY.md §7.6), so dense normal
equations in float64 on the host are exact and instant; a batched jnp path
is unnecessary at this scale. Edge error follows the g2o SE3 convention
e = log(Z^-1 X_i^-1 X_j) with right-perturbation Jacobians approximated at
small error (J_j = I, J_i = -Ad(X_j^-1 X_i)), which is the standard
Gauss-Newton linearization for well-initialized pose graphs.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

# the precision of every array of the optimizer: float64 as the program's;
# the correctness control sets float32 (bench360/reference/control.py)
FLOAT = np.float64


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], FLOAT)


def _exp_so3(w):
    th = np.linalg.norm(w)
    W = _skew(w)
    if th < 1e-10:
        return np.eye(3, dtype=FLOAT) + W
    return (
        np.eye(3, dtype=FLOAT)
        + np.sin(th) / th * W
        + (1 - np.cos(th)) / (th * th) * (W @ W)
    )


def _log_so3(R):
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(cos_t)
    if th < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], FLOAT) / 2
    if th > np.pi - 1e-4:
        # near pi the antisymmetric part vanishes (th/(2 sin th) diverges);
        # recover the axis from the symmetric part R ~ 2 nn^T - I instead —
        # a gross-drift loop edge must not blow up chi2/H to inf
        A = 0.5 * (R + np.eye(3, dtype=FLOAT))
        axis = np.sqrt(np.clip(np.diag(A), 0.0, None))
        # fix signs from the off-diagonals relative to the largest component
        k = int(np.argmax(axis))
        if axis[k] > 0:
            for i in range(3):
                if i != k and A[k, i] < 0:
                    axis[i] = -axis[i]
            axis = axis / max(np.linalg.norm(axis), 1e-12)
        return th * axis
    return th / (2 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], FLOAT
    )


def _exp_se3(xi):
    v, w = xi[:3], xi[3:]
    T = np.eye(4, dtype=FLOAT)
    R = _exp_so3(w)
    th = np.linalg.norm(w)
    W = _skew(w)
    if th < 1e-10:
        V = np.eye(3, dtype=FLOAT) + 0.5 * W
    else:
        V = (
            np.eye(3, dtype=FLOAT)
            + (1 - np.cos(th)) / th**2 * W
            + (th - np.sin(th)) / th**3 * (W @ W)
        )
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def _log_se3(T):
    w = _log_so3(T[:3, :3])
    th = np.linalg.norm(w)
    W = _skew(w)
    if th < 1e-10:
        Vinv = np.eye(3, dtype=FLOAT) - 0.5 * W
    else:
        Vinv = (
            np.eye(3, dtype=FLOAT)
            - 0.5 * W
            + (1 / th**2 - (1 + np.cos(th)) / (2 * th * np.sin(th))) * (W @ W)
        )
    return np.concatenate([Vinv @ T[:3, 3], w])


def _adjoint(T):
    R = T[:3, :3]
    t = T[:3, 3]
    A = np.zeros((6, 6), FLOAT)
    A[:3, :3] = R
    A[3:, 3:] = R
    A[:3, 3:] = _skew(t) @ R
    return A


@dataclasses.dataclass
class Edge:
    i: int
    j: int
    z: np.ndarray  # measured relative pose: X_i^-1 X_j
    info: np.ndarray  # 6x6 information


class GraphOptimizer:
    """The SE(3) path of the program's GraphOptimizer (rigidity 6), with
    its robust kernel; the SE(2) path is left out (no cell runs it)."""

    def __init__(self, robust: bool = False):
        self.robust = robust
        self.vertices: List[np.ndarray] = []
        self.edges: List[Edge] = []

    @staticmethod
    def _robust_weights(chi2s: np.ndarray) -> np.ndarray:
        """Dynamic Covariance Scaling weights (Agarwal et al., ICRA'13):
        w = min(1, 2*phi/(phi + chi2))^2 — redescending, so a grossly wrong
        edge's influence goes to ~zero instead of Huber's linear tail. The
        scale phi adapts to the graph (median edge chi2) with a floor of 1
        whitened unit: a floor is required because a freshly-integrated
        odometry chain satisfies its own edges EXACTLY (median chi2 = 0),
        and a purely median-scaled kernel would then also reject the good
        loop-closure edges, freezing the optimization at its start."""
        phi = max(float(np.median(chi2s)), 1.0)
        return np.minimum(1.0, 2.0 * phi / (phi + np.maximum(chi2s, 0.0))) ** 2

    # -- construction ----------------------------------------------------------
    def add_vertex(self, pose: np.ndarray) -> int:
        self.vertices.append(np.asarray(pose, FLOAT).copy())
        return len(self.vertices) - 1

    def add_edge(self, i: int, j: int, rel_pose: np.ndarray, information: np.ndarray) -> None:
        info = np.asarray(information, FLOAT)
        info = 0.5 * (info + info.T)
        # guard: non-PSD or degenerate information falls back to identity.
        # The negativity test carries a relative tolerance: a genuinely PSD
        # rank-deficient Hessian (planar scenes) rounds to ~+-1e-10 in
        # eigvalsh, and a hard ev[0] < 0 would discard its real weighting
        # on about half of such edges nondeterministically.
        ev = np.linalg.eigvalsh(info)
        if (
            not np.isfinite(ev).all()
            or ev[0] < -1e-9 * max(abs(ev[-1]), 1.0)
            or ev[-1] <= 0
        ):
            info = np.eye(6, dtype=FLOAT)
        self.edges.append(Edge(i, j, np.asarray(rel_pose, FLOAT).copy(), info))

    # -- optimization ------------------------------------------------------------
    def optimize_graph(self, iterations: int = 10, lam: float = 1e-6) -> float:
        """Levenberg-Marquardt over all vertices, vertex 0 fixed
        (reference GraphOptimizer.h:181-208). Returns the final chi2."""
        n = len(self.vertices)
        if n < 2 or not self.edges:
            return 0.0
        X = [v.copy() for v in self.vertices]

        def edge_chi2s(Xs):
            out = np.empty(len(self.edges), FLOAT)
            for k, e in enumerate(self.edges):
                err = _log_se3(np.linalg.inv(e.z) @ np.linalg.inv(Xs[e.i]) @ Xs[e.j])
                out[k] = float(err @ e.info @ err)
            return out

        # per-edge chi2 at the current linearization point, carried across
        # iterations so each LM step evaluates the edge set once (for Xnew)
        # instead of three times
        cs = edge_chi2s(X)
        for _ in range(iterations):
            # IRLS: weights from the per-edge chi2 at the linearization
            # point, held fixed for this step's build AND accept decision
            w = self._robust_weights(cs) if self.robust else np.ones(len(self.edges))
            H = np.zeros((6 * n, 6 * n), FLOAT)
            b = np.zeros(6 * n, FLOAT)
            for k, e in enumerate(self.edges):
                Xi, Xj = X[e.i], X[e.j]
                err = _log_se3(np.linalg.inv(e.z) @ np.linalg.inv(Xi) @ Xj)
                info_w = w[k] * e.info
                Jj = np.eye(6, dtype=FLOAT)
                Ji = -_adjoint(np.linalg.inv(Xj) @ Xi)
                for (a, Ja) in ((e.i, Ji), (e.j, Jj)):
                    for (c_, Jc) in ((e.i, Ji), (e.j, Jj)):
                        H[6 * a : 6 * a + 6, 6 * c_ : 6 * c_ + 6] += Ja.T @ info_w @ Jc
                    b[6 * a : 6 * a + 6] += Ja.T @ info_w @ err
            # fix vertex 0
            H = H[6:, 6:] + lam * np.diag(np.diag(H[6:, 6:]) + 1e-12)
            b = b[6:]
            try:
                delta = np.linalg.solve(H, -b)
            except np.linalg.LinAlgError:
                break
            Xnew = [X[0]] + [
                X[k] @ _exp_se3(delta[6 * (k - 1) : 6 * k]) for k in range(1, n)
            ]
            new_cs = edge_chi2s(Xnew)
            cur_w = float(w @ cs)
            new_w = float(w @ new_cs)
            if new_w <= cur_w:
                X = Xnew
                cs = new_cs
                if cur_w - new_w < 1e-12:
                    break
                lam = max(lam / 10, 1e-12)
            else:
                lam *= 10
        self.vertices = X
        return float(cs.sum())

    def get_poses(self) -> List[np.ndarray]:
        return [v.copy() for v in self.vertices]
