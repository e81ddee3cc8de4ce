"""Copy of rgbd360_tpu/core/graph_optimizer.py (numpy only): the port keeps
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


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float64)


def _exp_so3(w):
    th = np.linalg.norm(w)
    W = _skew(w)
    if th < 1e-10:
        return np.eye(3) + W
    return (
        np.eye(3)
        + np.sin(th) / th * W
        + (1 - np.cos(th)) / (th * th) * (W @ W)
    )


def _log_so3(R):
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(cos_t)
    if th < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    if th > np.pi - 1e-4:
        # near pi the antisymmetric part vanishes (th/(2 sin th) diverges);
        # recover the axis from the symmetric part R ~ 2 nn^T - I instead —
        # a gross-drift loop edge must not blow up chi2/H to inf
        A = 0.5 * (R + np.eye(3))
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
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )


def _exp_se3(xi):
    v, w = xi[:3], xi[3:]
    T = np.eye(4)
    R = _exp_so3(w)
    th = np.linalg.norm(w)
    W = _skew(w)
    if th < 1e-10:
        V = np.eye(3) + 0.5 * W
    else:
        V = (
            np.eye(3)
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
        Vinv = np.eye(3) - 0.5 * W
    else:
        Vinv = (
            np.eye(3)
            - 0.5 * W
            + (1 / th**2 - (1 + np.cos(th)) / (2 * th * np.sin(th))) * (W @ W)
        )
    return np.concatenate([Vinv @ T[:3, 3], w])


def _adjoint(T):
    R = T[:3, :3]
    t = T[:3, 3]
    A = np.zeros((6, 6))
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
    """Same interface family as the reference GraphOptimizer (g2o/MRPT).

    rigidity=6: SE(3) (g2o types_slam3d path, GraphOptimizer.h:103-140).
    rigidity=3: SE(2) (types_slam2d path, GraphOptimizer.h:84-140) — poses
    are still passed as 4x4; they are projected to the planar subspace
    (`planar_axis`: 'z' is the g2o convention; 'x' is the panorama up axis
    the PLANAR_3DoF registration modes constrain, ops/sphere.py docstring).
    """

    def __init__(self, rigidity: int = 6, planar_axis: str = "z",
                 robust: bool = False):
        assert rigidity in (3, 6), "3-DoF (SE2) or 6-DoF (SE3)"
        assert planar_axis in ("x", "z")
        self.rigidity = rigidity
        self.planar_axis = planar_axis
        # robust=True: self-scaling Huber kernel (IRLS) — an improvement
        # OVER the reference, whose g2o robustification (RRR) is disabled
        # (GraphOptimizer.h:29), leaving it defenceless against
        # false-positive loop closures: the LC accept gate
        # (avDepthResidual < 2.0) is loose by design, and one bad edge
        # measurably drags its vertex (observed 1.1 m on a 56-KF synthetic
        # loop whose other 145 edges were good). The kernel's scale is set
        # per iteration from the median edge chi2, so it needs no manual
        # tuning against the Hessian-scaled information matrices. Default
        # False = reference-parity plain quadratic.
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

    # -- SE2 projection helpers (rigidity=3) -----------------------------------
    def _t2v(self, T: np.ndarray) -> np.ndarray:
        """4x4 -> (a, b, theta) in the planar subspace."""
        if self.planar_axis == "z":
            return np.array([T[0, 3], T[1, 3], np.arctan2(T[1, 0], T[0, 0])])
        return np.array([T[1, 3], T[2, 3], np.arctan2(T[2, 1], T[1, 1])])

    def _v2t(self, v: np.ndarray) -> np.ndarray:
        a, b, th = v
        c, s = np.cos(th), np.sin(th)
        T = np.eye(4)
        if self.planar_axis == "z":
            T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
            T[0, 3], T[1, 3] = a, b
        else:
            T[1, 1], T[1, 2], T[2, 1], T[2, 2] = c, -s, s, c
            T[1, 3], T[2, 3] = a, b
        return T

    def _info3(self, info6: np.ndarray) -> np.ndarray:
        """3x3 planar information from a 6x6 twist-information matrix
        (twist order [v, w]): (t_a, t_b, omega_axis)."""
        idx = [0, 1, 5] if self.planar_axis == "z" else [1, 2, 3]
        return info6[np.ix_(idx, idx)]

    # -- construction ----------------------------------------------------------
    def add_vertex(self, pose: np.ndarray) -> int:
        self.vertices.append(np.asarray(pose, np.float64).copy())
        return len(self.vertices) - 1

    def add_edge(self, i: int, j: int, rel_pose: np.ndarray, information: np.ndarray) -> None:
        info = np.asarray(information, np.float64)
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
            info = np.eye(6)
        self.edges.append(Edge(i, j, np.asarray(rel_pose, np.float64).copy(), info))

    # -- optimization ------------------------------------------------------------
    def optimize_graph(self, iterations: int = 10, lam: float = 1e-6) -> float:
        """Levenberg-Marquardt over all vertices, vertex 0 fixed
        (reference GraphOptimizer.h:181-208). Returns the final chi2."""
        n = len(self.vertices)
        if n < 2 or not self.edges:
            return 0.0
        if self.rigidity == 3:
            return self._optimize_se2(iterations, lam)
        X = [v.copy() for v in self.vertices]

        def edge_chi2s(Xs):
            out = np.empty(len(self.edges))
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
            H = np.zeros((6 * n, 6 * n))
            b = np.zeros(6 * n)
            for k, e in enumerate(self.edges):
                Xi, Xj = X[e.i], X[e.j]
                err = _log_se3(np.linalg.inv(e.z) @ np.linalg.inv(Xi) @ Xj)
                info_w = w[k] * e.info
                Jj = np.eye(6)
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

    def _optimize_se2(self, iterations: int, lam: float) -> float:
        """Planar (SE2) Gauss-Newton/LM, the rigidity=3 path (reference
        GraphOptimizer.h:84-208 with g2o types_slam2d). Standard pose-graph
        linearization: e = t2v(Z^-1 Xi^-1 Xj) with the analytic A/B blocks."""
        n = len(self.vertices)
        V = [self._t2v(v) for v in self.vertices]
        Z = [(e.i, e.j, self._t2v(e.z), self._info3(e.info)) for e in self.edges]

        def rot2(th):
            c, s = np.cos(th), np.sin(th)
            return np.array([[c, -s], [s, c]])

        def wrap(a):
            return (a + np.pi) % (2 * np.pi) - np.pi

        def err(Vs, i, j, zv):
            Ri = rot2(Vs[i][2])
            dt = Vs[j][:2] - Vs[i][:2]
            e_t = rot2(zv[2]).T @ (Ri.T @ dt - zv[:2])
            e_th = wrap(Vs[j][2] - Vs[i][2] - zv[2])
            return np.array([e_t[0], e_t[1], e_th])

        def edge_chi2s(Vs):
            return np.array(
                [err(Vs, i, j, zv) @ info @ err(Vs, i, j, zv) for i, j, zv, info in Z]
            )

        cs = edge_chi2s(V)  # carried: one edge sweep per iteration, not three
        for _ in range(iterations):
            w = self._robust_weights(cs) if self.robust else np.ones(len(Z))
            H = np.zeros((3 * n, 3 * n))
            b = np.zeros(3 * n)
            for k_e, (i, j, zv, info) in enumerate(Z):
                info = w[k_e] * info
                Ri = rot2(V[i][2])
                Rz = rot2(zv[2])
                dt = V[j][:2] - V[i][:2]
                dRiT = np.array(
                    [[-np.sin(V[i][2]), np.cos(V[i][2])],
                     [-np.cos(V[i][2]), -np.sin(V[i][2])]]
                )  # d(Ri^T)/dtheta
                A = np.zeros((3, 3))
                A[:2, :2] = -Rz.T @ Ri.T
                A[:2, 2] = Rz.T @ dRiT @ dt
                A[2, 2] = -1.0
                B = np.zeros((3, 3))
                B[:2, :2] = Rz.T @ Ri.T
                B[2, 2] = 1.0
                e = err(V, i, j, zv)
                for (a_, Ja) in ((i, A), (j, B)):
                    for (c_, Jc) in ((i, A), (j, B)):
                        H[3 * a_ : 3 * a_ + 3, 3 * c_ : 3 * c_ + 3] += Ja.T @ info @ Jc
                    b[3 * a_ : 3 * a_ + 3] += Ja.T @ info @ e
            Hf = H[3:, 3:] + lam * np.diag(np.diag(H[3:, 3:]) + 1e-12)
            try:
                delta = np.linalg.solve(Hf, -b[3:])
            except np.linalg.LinAlgError:
                break
            Vnew = [V[0]] + [
                np.array(
                    [
                        V[k][0] + delta[3 * (k - 1)],
                        V[k][1] + delta[3 * (k - 1) + 1],
                        wrap(V[k][2] + delta[3 * (k - 1) + 2]),
                    ]
                )
                for k in range(1, n)
            ]
            new_cs = edge_chi2s(Vnew)
            cur_w = float(w @ cs)
            new_w = float(w @ new_cs)
            if new_w <= cur_w:
                V = Vnew
                cs = new_cs
                if cur_w - new_w < 1e-14:
                    break
                lam = max(lam / 10, 1e-12)
            else:
                lam *= 10
        self.vertices = [self._v2t(v) for v in V]
        return float(cs.sum())

    # -- accessors -----------------------------------------------------------------
    def get_poses(self) -> List[np.ndarray]:
        return [v.copy() for v in self.vertices]

    def vertex_count(self) -> int:
        return len(self.vertices)

    def save_graph(self, path: str) -> None:
        """g2o text format (VERTEX_SE3:QUAT / EDGE_SE3:QUAT), matching the
        reference's saveGraph output family (GraphOptimizer.h:273-277)."""
        def quat(R):
            # w,x,y,z from rotation matrix
            tr = np.trace(R)
            if tr > 0:
                s = np.sqrt(tr + 1) * 2
                return np.array(
                    [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, s / 4]
                )
            i = int(np.argmax(np.diag(R)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1, 1e-12)) * 2
            q = np.zeros(4)
            q[i] = s / 4
            q[j] = (R[j, i] + R[i, j]) / s
            q[k] = (R[k, i] + R[i, k]) / s
            q[3] = (R[k, j] - R[j, k]) / s
            return q

        if self.rigidity == 3:
            with open(path, "w") as f:
                for vid, v in enumerate(self.vertices):
                    a, b, th = self._t2v(v)
                    f.write(f"VERTEX_SE2 {vid} {a} {b} {th}\n")
                for e in self.edges:
                    a, b, th = self._t2v(e.z)
                    info3 = self._info3(e.info)
                    upper = info3[np.triu_indices(3)]
                    f.write(
                        f"EDGE_SE2 {e.i} {e.j} {a} {b} {th} "
                        + " ".join(map(str, upper)) + "\n"
                    )
            return
        with open(path, "w") as f:
            for vid, v in enumerate(self.vertices):
                q = quat(v[:3, :3])
                t = v[:3, 3]
                f.write(
                    f"VERTEX_SE3:QUAT {vid} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n"
                )
            for e in self.edges:
                q = quat(e.z[:3, :3])
                t = e.z[:3, 3]
                upper = e.info[np.triu_indices(6)]
                f.write(
                    f"EDGE_SE3:QUAT {e.i} {e.j} {t[0]} {t[1]} {t[2]} "
                    f"{q[0]} {q[1]} {q[2]} {q[3]} " + " ".join(map(str, upper)) + "\n"
                )
