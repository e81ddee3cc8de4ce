"""Plane-based map (PbMap) structures — native reimplementation of the
mrpt::pbmap types the reference leans on (SURVEY.md §2.1 'mrpt::pbmap'):
Plane (normal/center/d/curvature/hull/area/elongation/hue histogram/label,
isSamePlane/mergePlane/transform), PbMap, and geometry helpers. Host-side
NumPy — plane counts are tiny (tens); the per-pixel work that feeds them
runs on device (ops/normals.py, ops/planes_seg.py).

MRPT semantics are reconstructed from the reference's call sites and
thresholds (include/Frame360.h:657-832 merge logic, config_files/*.ini
matcher constraints); exactness is gated by end-pose parity, not
structure-for-structure (SURVEY.md §7 'Hard parts').

A copy of rgbd360_tpu/core/pbmap.py (numpy only); the .pbmap.npz files of
save_pbmap/load_pbmap are the same format in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

try:  # qhull accelerates convex_hull_2d; scipy is optional
    from scipy.spatial import ConvexHull as _ConvexHull, QhullError as _QhullError
except ImportError:  # pragma: no cover
    _ConvexHull, _QhullError = None, ()

HIST_H_BINS = 74  # 72 hue bins + black + white/gray


def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain. points: (N,2). Returns hull vertex indices CCW.

    Large inputs (plane patches carry up to ~77k inliers) first drop points
    strictly inside the octagon spanned by the 8 directional extremes — a
    vectorized, exactness-preserving reduction (an interior point of that
    octagon is interior to the hull, so it can never be a hull vertex);
    the Python chain then runs on the few boundary candidates. This was the
    single hottest host op of plane extraction (0.46 s/frame -> ~10 ms)."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n >= 8 and _ConvexHull is not None:
        # qhull fast path (~5x less Python overhead than the chain at the
        # typical ~100-400 octagon-boundary candidates per plane); the
        # monotone chain below stays as the degenerate-input fallback
        try:
            return _ConvexHull(pts).vertices  # CCW for 2-D inputs
        except (_QhullError, ValueError):
            pass
    sub = None
    if n > 64:
        x, y = pts[:, 0], pts[:, 1]
        proj = np.stack([x, y, x + y, x - y], axis=1)
        extremes = {int(np.argmin(proj[:, k])) for k in range(4)} | {
            int(np.argmax(proj[:, k])) for k in range(4)
        }
        ex = pts[sorted(extremes)]
        c = ex.mean(axis=0)
        poly = ex[np.argsort(np.arctan2(ex[:, 1] - c[1], ex[:, 0] - c[0]))]
        strictly_inside = np.ones(n, bool)
        for i in range(len(poly)):
            a, b = poly[i], poly[(i + 1) % len(poly)]
            e = b - a
            cr = e[0] * (y - a[1]) - e[1] * (x - a[0])
            strictly_inside &= cr > 1e-12  # strictly left of every CCW edge
        sub = np.flatnonzero(~strictly_inside)
        pts = pts[sub]

    order = np.lexsort((pts[:, 1], pts[:, 0]))
    # plain-float lists: the chain loop touches every point a few times and
    # numpy scalar indexing costs ~10x a list access at this size
    xs = pts[:, 0].tolist()
    ys = pts[:, 1].tolist()

    def half(indices):
        out = []
        push = out.append
        pop = out.pop
        for i in indices:
            xi, yi = xs[i], ys[i]
            while len(out) >= 2:
                a = out[-1]
                o = out[-2]
                ox, oy = xs[o], ys[o]
                # 2-D cross product z-component (np.cross on 2-vectors is
                # removed in NumPy 2.x)
                if (xs[a] - ox) * (yi - oy) - (ys[a] - oy) * (xi - ox) <= 0:
                    pop()
                else:
                    break
            push(i)
        return out

    lower = half(order.tolist())
    upper = half(order[::-1].tolist())
    hull = np.array(lower[:-1] + upper[:-1], int)
    return sub[hull] if sub is not None else hull


def polygon_area_centroid(poly2d: np.ndarray):
    """Shoelace area + centroid of a 2D polygon (CCW)."""
    x, y = poly2d[:, 0], poly2d[:, 1]
    xn, yn = np.concatenate([x[1:], x[:1]]), np.concatenate([y[1:], y[:1]])
    cross = x * yn - xn * y
    area = 0.5 * np.sum(cross)
    if abs(area) < 1e-12:
        return 0.0, poly2d.mean(axis=0)
    cx = np.sum((x + xn) * cross) / (6.0 * area)
    cy = np.sum((y + yn) * cross) / (6.0 * area)
    return abs(area), np.array([cx, cy])


def dist3d_segment_segment(p1, p2, q1, q2) -> float:
    """Squared distance between segments [p1,p2] and [q1,q2]
    (geometry helper mirroring mrpt::pbmap::dist3D_Segment_to_Segment2,
    used at reference include/Frame360.h:698)."""
    u = p2 - p1
    v = q2 - q1
    w = p1 - q1
    a, b, c = u @ u, u @ v, v @ v
    d, e = u @ w, v @ w
    D = a * c - b * b
    sN, sD, tN, tD = 0.0, D, 0.0, D
    if D < 1e-12:
        sN, sD = 0.0, 1.0
        tN, tD = e, c
    else:
        sN = b * e - c * d
        tN = a * e - b * d
        if sN < 0:
            sN = 0.0
            tN, tD = e, c
        elif sN > sD:
            sN = sD
            tN, tD = e + b, c
    if tN < 0:
        tN = 0.0
        sN = np.clip(-d, 0, a) if a > 1e-12 else 0.0
        sD = a if a > 1e-12 else 1.0
    elif tN > tD:
        tN = tD
        sN = np.clip(-d + b, 0, a) if a > 1e-12 else 0.0
        sD = a if a > 1e-12 else 1.0
    sc = sN / sD if abs(sD) > 1e-12 else 0.0
    tc = tN / tD if abs(tD) > 1e-12 else 0.0
    dP = w + sc * u - tc * v
    return float(dP @ dP)


def dist3d_segment_segment_batch(a0, a1, b0, b1) -> np.ndarray:
    """Squared distances between every segment [a0[i], a1[i]] and every
    segment [b0[j], b1[j]]: (E1, E2) array. Vectorized restatement of
    dist3d_segment_segment (same clamped-closest-point algorithm); replaces
    the per-edge-pair Python loop in plane grouping, which profiled as the
    hottest remaining host op of plane extraction."""
    a0 = np.asarray(a0, np.float64)[:, None, :]
    a1 = np.asarray(a1, np.float64)[:, None, :]
    b0 = np.asarray(b0, np.float64)[None, :, :]
    b1 = np.asarray(b1, np.float64)[None, :, :]
    u = a1 - a0
    v = b1 - b0
    w = a0 - b0
    a = np.einsum("ijk,ijk->ij", u, u)
    b = np.einsum("ijk,ijk->ij", u, v)
    c = np.einsum("ijk,ijk->ij", v, v)
    d = np.einsum("ijk,ijk->ij", u, w)
    e = np.einsum("ijk,ijk->ij", v, w)
    D = a * c - b * b
    par = D < 1e-12
    sN = np.where(par, 0.0, b * e - c * d)
    sD = np.where(par, 1.0, D)
    tN = np.where(par, e, a * e - b * d)
    tD = np.where(par, c, D)
    # clamp s to [0, 1]
    low = ~par & (sN < 0)
    sN = np.where(low, 0.0, sN)
    tN = np.where(low, e, tN)
    tD = np.where(low, c, tD)
    high = ~par & ~low & (sN > sD)
    sN = np.where(high, sD, sN)
    tN = np.where(high, e + b, tN)
    tD = np.where(high, c, tD)
    # clamp t to [0, 1], re-clamping s
    a_ok = a > 1e-12
    tlow = tN < 0
    sN = np.where(tlow, np.where(a_ok, np.clip(-d, 0.0, a), 0.0), sN)
    sD = np.where(tlow, np.where(a_ok, a, 1.0), sD)
    tN = np.where(tlow, 0.0, tN)
    thigh = ~tlow & (tN > tD)
    sN = np.where(thigh, np.where(a_ok, np.clip(-d + b, 0.0, a), 0.0), sN)
    sD = np.where(thigh, np.where(a_ok, a, 1.0), sD)
    tN = np.where(thigh, tD, tN)
    sc = np.where(np.abs(sD) > 1e-12, sN / np.where(np.abs(sD) > 1e-12, sD, 1.0), 0.0)
    tc = np.where(np.abs(tD) > 1e-12, tN / np.where(np.abs(tD) > 1e-12, tD, 1.0), 0.0)
    dP = w + sc[..., None] * u - tc[..., None] * v
    return np.einsum("ijk,ijk->ij", dP, dP)


def rgb_to_hue_hist(rgb: np.ndarray) -> np.ndarray:
    """74-bin hue histogram of inlier colors (normalized to sum 1):
    72 hue bins + bin 72 for dark (V<0.3) + bin 73 for unsaturated (S<0.2)
    (reconstruction of mrpt::pbmap::Plane::calcPlaneHistH)."""
    c = rgb.astype(np.float64) / 255.0
    v = c.max(axis=-1)
    mn = c.min(axis=-1)
    s = np.where(v > 1e-9, (v - mn) / np.maximum(v, 1e-9), 0.0)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    delta = np.maximum(v - mn, 1e-9)
    h = np.where(
        v == r,
        (g - b) / delta % 6.0,
        np.where(v == g, (b - r) / delta + 2.0, (r - g) / delta + 4.0),
    ) * 60.0
    bins = np.clip((h / 360.0 * 72).astype(int), 0, 71)
    bins = np.where(v < 0.3, 72, np.where(s < 0.2, 73, bins))
    hist = np.bincount(bins.reshape(-1), minlength=HIST_H_BINS).astype(np.float64)
    n = hist.sum()
    return hist / n if n > 0 else hist


def bhattacharyya(h1: np.ndarray, h2: np.ndarray) -> float:
    """Bhattacharyya coefficient of two normalized histograms (1 = identical)."""
    return float(np.sum(np.sqrt(h1 * h2)))


@dataclasses.dataclass
class Plane:
    """A planar patch (native equivalent of mrpt::pbmap::Plane)."""

    id: int = 0
    normal: np.ndarray = None  # (3,) unit, oriented toward the sensor
    center: np.ndarray = None  # (3,) centroid of inliers
    d: float = 0.0  # plane offset: d = -normal . center
    curvature: float = 0.0
    inliers: np.ndarray = None  # flat indices into the (sphere) cloud
    points: np.ndarray = None  # (N,3) inlier points (subsampled ok)
    colors: Optional[np.ndarray] = None  # (N,3) uint8 RGB of inliers
    hull: np.ndarray = None  # (K,3) convex hull polygon vertices
    area_hull: float = 0.0
    elongation: float = 1.0
    ppal_dir: np.ndarray = None  # (3,) principal direction in-plane
    hist_h: np.ndarray = None
    main_color: Optional[np.ndarray] = None
    label: str = ""
    # sufficient statistics of the inlier distribution (n, centroid=center,
    # centered 3x3 covariance, raw hue-histogram counts): when present, the
    # device-side extraction path carries these instead of raw points, and
    # merge_plane combines them additively (parallel-axis theorem) — the
    # re-estimated parameters equal the point-union re-estimate exactly
    n_pts: int = 0
    cov: Optional[np.ndarray] = None  # (3,3) centered covariance
    hist_counts: Optional[np.ndarray] = None  # (HIST_H_BINS,) raw counts
    # centroid OF THE SUFFICIENT STATISTICS (refined members) when it differs
    # from the reported center: the reported center/normal/curvature of an
    # unmerged plane are the segment-stage (pre-refine) fit, PCL-style, while
    # n_pts/cov describe the refined member set — a moment merge must pair
    # cov with ITS OWN centroid or the parallel-axis combination is wrong.
    # None = center and suffstat centroid coincide (merged planes, host path).
    ss_center: Optional[np.ndarray] = None

    # -- derived geometry ----------------------------------------------------
    def plane_basis(self):
        n = self.normal
        # manual cross products: np.cross dominates profile at this call
        # count (moveaxis/broadcast overhead on 3-vectors)
        if abs(n[0]) < 0.9:  # a = x axis
            u = np.array([0.0, n[2], -n[1]])
        else:  # a = y axis
            u = np.array([-n[2], 0.0, n[0]])
        u /= np.linalg.norm(u)
        v = np.array(
            [
                n[1] * u[2] - n[2] * u[1],
                n[2] * u[0] - n[0] * u[2],
                n[0] * u[1] - n[1] * u[0],
            ]
        )
        return u, v

    def compute_hull_area(self, contour_points: np.ndarray) -> None:
        """calcConvexHull + computeMassCenterAndArea + calcElongationAndPpalDir."""
        u, v = self.plane_basis()
        rel = contour_points - self.center
        p2 = np.stack([rel @ u, rel @ v], axis=-1)
        if len(p2) < 3:
            self.hull = contour_points.copy()
            self.area_hull = 0.0
            return
        hull_idx = convex_hull_2d(p2)
        if len(hull_idx) < 3:
            self.hull = contour_points[hull_idx]
            self.area_hull = 0.0
            return
        poly = p2[hull_idx]
        area, c2 = polygon_area_centroid(poly)
        self.hull = contour_points[hull_idx]
        self.area_hull = float(area)
        self.mass_center = self.center + c2[0] * u + c2[1] * v
        # elongation: principal second moments of the hull polygon vertices
        # (closed-form 2x2 eigenpair; np.linalg.eigh cost ~40 us/call at the
        # ~60 hulls/frame of the extraction hot path)
        m = poly - poly.mean(axis=0)
        n_m = len(m)
        a = float(m[:, 0] @ m[:, 0]) / n_m
        b = float(m[:, 0] @ m[:, 1]) / n_m
        c = float(m[:, 1] @ m[:, 1]) / n_m
        half_tr = 0.5 * (a + c)
        disc = np.sqrt(max(half_tr * half_tr - (a * c - b * b), 0.0))
        w_max, w_min = half_tr + disc, half_tr - disc
        self.elongation = float(np.sqrt(max(w_max, 1e-12) / max(w_min, 1e-12)))
        if abs(b) > 1e-18:
            e0, e1 = b, w_max - a
        else:  # diagonal covariance: principal axis is a coordinate axis
            e0, e1 = (1.0, 0.0) if a >= c else (0.0, 1.0)
        nrm = np.hypot(e0, e1)
        e0, e1 = e0 / nrm, e1 / nrm
        self.ppal_dir = e0 * u + e1 * v

    def compute_colors(self) -> None:
        if self.colors is not None and len(self.colors):
            self.hist_h = rgb_to_hue_hist(self.colors)
            self.main_color = self.colors.mean(axis=0) / 255.0
        else:
            self.hist_h = np.zeros(HIST_H_BINS)
            self.main_color = np.zeros(3)

    def transform(self, rt: np.ndarray) -> None:
        """Rigidly transform all geometry (mrpt::pbmap::Plane::transform)."""
        R, t = rt[:3, :3], rt[:3, 3]
        self.normal = R @ self.normal
        self.center = R @ self.center + t
        if self.ss_center is not None:
            self.ss_center = R @ self.ss_center + t
        if self.ppal_dir is not None:
            self.ppal_dir = R @ self.ppal_dir
        self.d = float(-self.normal @ self.center)
        if self.points is not None:
            self.points = self.points @ R.T + t
        if self.hull is not None:
            self.hull = self.hull @ R.T + t
        if self.cov is not None:
            self.cov = R @ self.cov @ R.T

    # -- predicates ----------------------------------------------------------
    def is_plane_nearby(self, other: "Plane", dist_threshold: float) -> bool:
        """Hull-proximity test: any vertex/edge pair within dist_threshold."""
        h1, h2 = self.hull, other.hull
        if h1 is None or h2 is None or len(h1) == 0 or len(h2) == 0:
            return False
        dd = np.linalg.norm(h1[:, None, :] - h2[None, :, :], axis=-1)
        if dd.min() < dist_threshold:
            return True
        thr2 = dist_threshold * dist_threshold
        d2 = dist3d_segment_segment_batch(
            h1, np.roll(h1, -1, axis=0), h2, np.roll(h2, -1, axis=0)
        )
        return bool(d2.min() < thr2)

    def is_same_plane(
        self,
        other: "Plane",
        cos_angle_thr: float,
        dist_thr: float,
        prox_thr: float,
    ) -> bool:
        """mrpt::pbmap::Plane::isSamePlane(plane, cosAngle, dist, proximity)
        as called at reference include/Frame360.h:917, 1058."""
        if float(self.normal @ other.normal) < cos_angle_thr:
            return False
        if abs(float(self.normal @ (other.center - self.center))) > dist_thr:
            return False
        return self.is_plane_nearby(other, prox_thr)

    def merge_plane(self, other: "Plane") -> None:
        """Merge `other` into self, re-estimating parameters from the union
        (mrpt::pbmap::Plane::mergePlane2).

        When both planes carry sufficient statistics (n_pts/cov from the
        device extraction path) the union's centroid/covariance come from
        the additive parallel-axis combination — numerically identical to
        re-estimating from concatenated points, without materializing them.
        """
        if self.inliers is not None and other.inliers is not None:
            self.inliers = np.concatenate([self.inliers, other.inliers])
        else:  # need_inliers=False extraction: indices were never shipped
            self.inliers = None
        use_moments = (
            self.cov is not None and other.cov is not None
            and self.n_pts > 0 and other.n_pts > 0
        )
        if use_moments:
            n1, n2 = self.n_pts, other.n_pts
            n = n1 + n2
            c1 = self.ss_center if self.ss_center is not None else self.center
            c2 = other.ss_center if other.ss_center is not None else other.center
            center = (n1 * c1 + n2 * c2) / n
            d1 = c1 - center
            d2 = c2 - center
            cov = (
                n1 * (self.cov + np.outer(d1, d1))
                + n2 * (other.cov + np.outer(d2, d2))
            ) / n
            self.n_pts = n
            self.cov = cov
            # the merged plane is refit from the refined-member union
            # (reference mergePlane2 semantics): reported and suffstat
            # centroids coincide from here on
            self.ss_center = None
        else:
            pts = np.concatenate([self.points, other.points], axis=0)
            if self.colors is not None and other.colors is not None:
                self.colors = np.concatenate([self.colors, other.colors], axis=0)
            center = pts.mean(axis=0)
            cov = (pts - center).T @ (pts - center) / len(pts)
            self.points = pts
        w, vec = np.linalg.eigh(cov)
        normal = vec[:, 0]
        if normal @ center > 0:
            normal = -normal
        self.center = center
        self.normal = normal
        self.d = float(-normal @ center)
        self.curvature = float(w[0] / max(w.sum(), 1e-12))
        hull_pts = np.concatenate([self.hull, other.hull], axis=0)
        self.compute_hull_area(hull_pts)
        if use_moments and self.hist_counts is not None and other.hist_counts is not None:
            self.hist_counts = self.hist_counts + other.hist_counts
            total = self.hist_counts.sum()
            self.hist_h = self.hist_counts / total if total > 0 else self.hist_counts
            if self.main_color is not None and other.main_color is not None:
                n1, n2 = self.n_pts - other.n_pts, other.n_pts
                self.main_color = (n1 * self.main_color + n2 * other.main_color) / self.n_pts
        else:
            self.compute_colors()


@dataclasses.dataclass
class PbMap:
    planes: List[Plane] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.planes)

    def total_area(self) -> float:
        return float(sum(p.area_hull for p in self.planes))


def get_vertical_planes(pbmap: PbMap, min_area: float = 2.0) -> List[np.ndarray]:
    """2D wall segments from large planes whose normal is nearly parallel to
    the rig x-axis: for each, the hull vertices' (y, z) coordinates farthest
    from the centroid on either side of the centroid's z become the segment
    endpoints (y_r, z_r, y_l, z_l). Reference include/Miscellaneous.h:208-257
    getVerticalPlanes — dead code there (its only call,
    RegisterGraphSphere.cpp:996, is commented out), provided for API parity.
    Unlike the C++ (whose one-sided hulls read uninitialized extremes), an
    empty side degrades to the centroid."""
    out: List[np.ndarray] = []
    for p in pbmap.planes:
        if p.normal is None or p.normal[0] < 0.98:
            continue
        if p.area_hull < min_area or p.hull is None or len(p.hull) == 0:
            continue
        c2 = np.array([p.center[1], p.center[2]], np.float64)
        v2 = np.asarray(p.hull, np.float64)[:, 1:3]
        dist = np.linalg.norm(v2 - c2, axis=1)
        right_side = v2[:, 1] > c2[1]
        extremes = []
        for side in (right_side, ~right_side):
            d_side = np.where(side, dist, -1.0)
            extremes.append(v2[int(np.argmax(d_side))] if side.any() else c2)
        out.append(np.concatenate(extremes).astype(np.float32))
    return out


# -- (de)serialization ---------------------------------------------------------


def save_pbmap(pbmap: PbMap, path: str) -> None:
    """Persist a PbMap (reference Frame360::savePlanes, Frame360.h:321-330,
    streams mrpt pbmap through a gzip stream; here the plane set is stored as
    a compressed npz of fixed arrays + ragged hull/point buffers)."""
    n = len(pbmap.planes)
    hulls = [p.hull if p.hull is not None else np.zeros((0, 3)) for p in pbmap.planes]
    points = [p.points if p.points is not None else np.zeros((0, 3)) for p in pbmap.planes]
    np.savez_compressed(
        path,
        n=n,
        ids=np.array([p.id for p in pbmap.planes], np.int64),
        normals=np.stack([p.normal for p in pbmap.planes]) if n else np.zeros((0, 3)),
        centers=np.stack([p.center for p in pbmap.planes]) if n else np.zeros((0, 3)),
        d=np.array([p.d for p in pbmap.planes]),
        curvature=np.array([p.curvature for p in pbmap.planes]),
        area_hull=np.array([p.area_hull for p in pbmap.planes]),
        elongation=np.array([p.elongation for p in pbmap.planes]),
        ppal_dir=np.stack(
            [p.ppal_dir if p.ppal_dir is not None else np.zeros(3) for p in pbmap.planes]
        ) if n else np.zeros((0, 3)),
        hist_h=np.stack(
            [p.hist_h if p.hist_h is not None else np.zeros(HIST_H_BINS) for p in pbmap.planes]
        ) if n else np.zeros((0, HIST_H_BINS)),
        main_color=np.stack(
            [p.main_color if p.main_color is not None else np.zeros(3) for p in pbmap.planes]
        ) if n else np.zeros((0, 3)),
        labels=np.array([p.label for p in pbmap.planes], dtype=object),
        hull_data=np.concatenate(hulls, axis=0) if n else np.zeros((0, 3)),
        hull_offsets=np.cumsum([0] + [len(h) for h in hulls]),
        point_data=np.concatenate(points, axis=0) if n else np.zeros((0, 3)),
        point_offsets=np.cumsum([0] + [len(pt) for pt in points]),
        # sufficient statistics (device extraction path); zeros when absent
        n_pts=np.array([p.n_pts for p in pbmap.planes], np.int64),
        covs=np.stack(
            [p.cov if p.cov is not None else np.zeros((3, 3)) for p in pbmap.planes]
        ) if n else np.zeros((0, 3, 3)),
        hist_counts=np.stack(
            [
                p.hist_counts if p.hist_counts is not None else np.zeros(HIST_H_BINS)
                for p in pbmap.planes
            ]
        ) if n else np.zeros((0, HIST_H_BINS)),
        # suffstat centroid where it differs from the reported (pre-refine)
        # center; NaN = coincides (merged planes / host path)
        ss_centers=np.stack(
            [
                p.ss_center if p.ss_center is not None else np.full(3, np.nan)
                for p in pbmap.planes
            ]
        ) if n else np.zeros((0, 3)),
    )


def load_pbmap(path: str) -> PbMap:
    """Inverse of save_pbmap (reference Frame360::loadPbMap, Frame360.h:197-209)."""
    with np.load(path, allow_pickle=True) as z:
        # hoist every array once: NpzFile re-decompresses the full member on
        # each z[key] access, which made loading O(n^2) in data volume
        a = {k: z[k] for k in z.files}
    n = int(a["n"])
    planes = []
    for i in range(n):
        h0, h1 = a["hull_offsets"][i], a["hull_offsets"][i + 1]
        p0, p1 = a["point_offsets"][i], a["point_offsets"][i + 1]
        pts = a["point_data"][p0:p1]
        planes.append(
            Plane(
                id=int(a["ids"][i]),
                normal=a["normals"][i],
                center=a["centers"][i],
                d=float(a["d"][i]),
                curvature=float(a["curvature"][i]),
                area_hull=float(a["area_hull"][i]),
                elongation=float(a["elongation"][i]),
                ppal_dir=a["ppal_dir"][i],
                hist_h=a["hist_h"][i],
                main_color=a["main_color"][i],
                label=str(a["labels"][i]),
                hull=a["hull_data"][h0:h1],
                points=pts if len(pts) else None,
                # older checkpoints predate the moment fields
                n_pts=int(a["n_pts"][i]) if "n_pts" in a else 0,
                cov=(a["covs"][i] if "covs" in a and int(a["n_pts"][i]) > 0 else None),
                hist_counts=(
                    a["hist_counts"][i]
                    if "hist_counts" in a and int(a["n_pts"][i]) > 0
                    else None
                ),
                ss_center=(
                    a["ss_centers"][i]
                    if "ss_centers" in a and np.isfinite(a["ss_centers"][i]).all()
                    else None
                ),
            )
        )
    return PbMap(planes)
