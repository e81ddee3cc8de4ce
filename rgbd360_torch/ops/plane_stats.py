"""On-device per-label plane statistics + hull-candidate extraction.

Counterpart of rgbd360_tpu/ops/plane_stats.py: the per-component fitting of
plane extraction (reference include/Frame360.h:979-1075 getPlanesSensor:
centroid / covariance / eigendecomposition / contour) runs on the device, so
only per-plane statistics, a hull-candidate mask and the f16 candidate
coordinates go to the host. Per sensor:

  * per-label counts and coordinate sums (bins are flat pixel indices);
  * the top-K labels by count (K = 64), ties to the lower label as
    ``jax.lax.top_k`` breaks them (a stable descending sort);
  * a second, centered pass -> per-label 3x3 covariance;
  * the closed-form symmetric 3x3 eigensolver -> eigenvalues,
    sensor-oriented normal, curvature;
  * the octagon-of-extremes hull prefilter: per-label maxima over 8
    in-plane directions, one witness pixel each, a point-in-octagon test
    per pixel (conservative margin, so every true hull vertex survives);
  * the per-label 74-bin hue histogram and RGB sums.

The JAX function takes one sensor and is vmapped; this one takes (S, ...).
The per-label sums (ops/planes_seg.py::_bin_sum) add each label's values in
pixel order, as XLA's CPU scatter, on the CPU and on the card alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rgbd360_torch.ops.normals import cross3, dot3
from rgbd360_torch.ops.planes_seg import MIN_INLIERS, _bin_sum, _gather_rows, _second_moments, top_k_stable  # noqa: F401

MAX_LABELS = 64  # top-K per-sensor label budget
HIST_H_BINS = 74
_OCT_EPS = 1e-5  # conservative inside-test margin (m^2 cross-product units)


class SensorPlaneStats(NamedTuple):
    """Per-sensor rows, S leading (plane_stats.py:46): mean/cov/count are the
    REFINED members (the merge sufficient statistics); mean_pre/evals/
    normal/curvature the segment-stage (pre-refine) fit, the reported plane
    parameters of unmerged planes."""

    labels: torch.Tensor  # (S, H, W) i32 refined labels, -1 invalid
    candidate: torch.Tensor  # (S, H, W) bool hull-candidate mask
    label_id: torch.Tensor  # (S, K) i64 original label of each selected row
    count: torch.Tensor  # (S, K) i32 refined inlier count (0 = empty slot)
    mean: torch.Tensor  # (S, K, 3) f32 refined-member centroid
    cov: torch.Tensor  # (S, K, 3, 3) f32 refined-member covariance (centered)
    evals: torch.Tensor  # (S, K, 3) f32 descending eigenvalues (pre-refine fit)
    normal: torch.Tensor  # (S, K, 3) f32 unit normal toward the sensor (pre-refine)
    curvature: torch.Tensor  # (S, K) f32 lambda_min / trace (pre-refine)
    hist: torch.Tensor  # (S, K, 74) f32 raw hue-histogram counts (refined)
    sum_rgb: torch.Tensor  # (S, K, 3) f32 sums of RGB inlier colors (refined)
    mean_pre: torch.Tensor  # (S, K, 3) f32 segment-stage centroid (reported)


def _eigh3x3(cov: torch.Tensor):
    """Batched closed-form symmetric 3x3 eigendecomposition, trig method
    (plane_stats.py:72). cov: (..., 3, 3). Returns (evals (..., 3)
    descending, evec_min (..., 3) the eigenvector of the smallest)."""
    a00, a11, a22 = cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2]
    a01, a02, a12 = cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2]
    p1 = torch.addcmul(torch.addcmul(a01 * a01, a02, a02), a12, a12)
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    # B = (A - q I) / p ; r = det(B) / 2
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02) + b02 * (b01 * b12 - b11 * b02)
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)  # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e2 = 3.0 * q - e1 - e3
    # near-diagonal matrices: the sorted diagonal
    dsort = torch.sort(torch.stack([a00, a11, a22], dim=-1), dim=-1, descending=True).values
    tiny = p1 < 1e-20
    evals = torch.where(tiny[..., None], dsort, torch.stack([e1, e2, e3], dim=-1))

    # eigenvector of the smallest eigenvalue: the largest cross product of
    # two rows of (A - e3 I)
    lam = evals[..., 2]
    r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
    c0, c1, c2 = cross3(r1, r2), cross3(r2, r0), cross3(r0, r1)
    n0, n1, n2 = dot3(c0, c0), dot3(c1, c1), dot3(c2, c2)
    best = torch.where(((n0 >= n1) & (n0 >= n2))[..., None], c0, torch.where((n1 >= n2)[..., None], c1, c2))
    nrm = torch.sqrt(torch.clamp(dot3(best, best), min=1e-30))[..., None]
    vec = best / nrm
    # degenerate (isotropic) fallback: the z axis
    iso = (n0 < 1e-30) & (n1 < 1e-30) & (n2 < 1e-30)
    vec = torch.where(iso[..., None], torch.tensor([0.0, 0.0, 1.0], dtype=vec.dtype, device=vec.device), vec)
    return evals, vec


def _plane_basis(n: torch.Tensor):
    """Orthonormal in-plane basis, the convention of pbmap.Plane.plane_basis
    (plane_stats.py:133): a = x if |n_x| < 0.9 else y; u = normalize(n x a);
    v = n x u."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ax = torch.where((torch.abs(n[..., 0]) < 0.9)[..., None], ex, ey)
    u = cross3(n, ax)
    u = u / torch.sqrt(torch.clamp(dot3(u, u), min=1e-30))[..., None]
    return u, cross3(n, u)


def _hue_bins(rgb_bgr_u8: torch.Tensor) -> torch.Tensor:
    """74-bin hue bin index per pixel (core/pbmap.rgb_to_hue_hist semantics,
    plane_stats.py:147); input in the stored BGR byte order."""
    c = rgb_bgr_u8.to(torch.float32) / 255.0
    b, g, r = c[..., 0], c[..., 1], c[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    zero = torch.zeros((), device=c.device)
    s = torch.where(v > 1e-9, (v - mn) / torch.clamp(v, min=1e-9), zero)
    delta = torch.clamp(v - mn, min=1e-9)
    # JAX's `%` is a floored modulo: torch.remainder, not torch.fmod
    h = torch.where(
        v == r,
        torch.remainder((g - b) / delta, 6.0),
        torch.where(v == g, (b - r) / delta + 2.0, (r - g) / delta + 4.0),
    ) * 60.0
    bins = torch.clamp((h / 360.0 * 72.0).to(torch.int32), 0, 71)
    return torch.where(v < 0.3, 72, torch.where(s < 0.2, 73, bins))


# 8 directions at 45 degrees, in angular (CCW) order (plane_stats.py:175)
_SQ2 = 0.7071067811865476
_OCT_DIRS = (
    (1.0, 0.0), (_SQ2, _SQ2), (0.0, 1.0), (-_SQ2, _SQ2),
    (-1.0, 0.0), (-_SQ2, -_SQ2), (0.0, -1.0), (_SQ2, -_SQ2),
)


def sensor_plane_stats(
    xyz: torch.Tensor,  # (S, H, W, 3) f32, NaN-invalid
    rgb_bgr: torch.Tensor,  # (S, H, W, 3) u8 BGR
    labels: torch.Tensor,  # (S, H, W) i32 REFINED labels (-1 invalid)
    labels_pre: torch.Tensor,  # (S, H, W) i32 segment-stage labels; a subset
    # of the refined ids, so both bin into the same top-K slots
) -> SensorPlaneStats:
    s, h, w = labels.shape
    hw = h * w
    K = MAX_LABELS
    dev = xyz.device
    zero = torch.zeros((), device=dev)
    labf = labels.reshape(s, hw)
    labeled = labf >= 0
    bin_ = torch.where(labeled, labf, hw).to(torch.int64)
    labeled_pre = labels_pre.reshape(s, hw) >= 0
    bin_pre = torch.where(labeled_pre, labels_pre.reshape(s, hw), hw).to(torch.int64)
    p = torch.where(torch.isfinite(xyz), xyz, zero).reshape(s, hw, 3)

    # pass 1 (refined): counts + coordinate sums — the merge suffstats basis
    feat1 = torch.cat([torch.ones((s, hw, 1), device=dev), p], dim=-1)
    feat1 = torch.where(labeled[..., None], feat1, zero)
    s1 = _bin_sum(bin_, feat1, hw + 1)
    topc, topi = top_k_stable(s1[:, :hw, 0], K)
    count = topc.to(torch.int32)
    mean = _gather_rows(s1[..., 1:4], topi) / torch.clamp(topc[..., None], min=1.0)

    # inverse table: label -> selected slot (K = not selected / invalid)
    inv = torch.full((s, hw + 1), K, dtype=torch.int64, device=dev)
    inv.scatter_(1, topi, torch.arange(K, device=dev).expand(s, K).contiguous())
    pix_k = torch.gather(inv, 1, bin_)
    pix_k_pre = torch.gather(inv, 1, bin_pre)

    # pass 1b (pre): the segment-stage centroid (the reported center)
    feat1p = torch.where(labeled_pre[..., None], feat1, zero)
    s1p = _bin_sum(pix_k_pre, feat1p, K + 1)[:, :K]
    cnt_pre = s1p[..., 0]
    mean_pre = s1p[..., 1:4] / torch.clamp(cnt_pre[..., None], min=1.0)

    # pass 2 (refined): centered second moments — merge suffstats
    pad = torch.zeros((s, 1, 3), device=dev)
    in_sel = labeled & (pix_k < K)
    mean_pre_pad = torch.cat([mean_pre, pad], dim=1)
    d = p - _gather_rows(torch.cat([mean, pad], dim=1), pix_k)
    d = torch.where(in_sel[..., None], d, zero)
    cov = _second_moments(d, pix_k, K + 1, K, topc)

    # pass 2b (pre): the segment-stage fit — reported normal/curvature
    d_pre = p - _gather_rows(mean_pre_pad, pix_k_pre)
    d_pre = torch.where((labeled_pre & (pix_k_pre < K))[..., None], d_pre, zero)
    cov_pre = _second_moments(d_pre, pix_k_pre, K + 1, K, cnt_pre)
    evals, n_min = _eigh3x3(cov_pre)
    flip = dot3(n_min, mean_pre) > 0  # toward the sensor (Frame360.h:988-992)
    normal = torch.where(flip[..., None], -n_min, n_min)
    curvature = evals[..., 2] / torch.clamp(evals.sum(-1), min=1e-12)

    # octagon-of-extremes candidate mask over the REFINED members, in the
    # reported (pre-fit) plane basis — the frame the host hull uses
    u, v = _plane_basis(normal)
    d_oct = p - _gather_rows(mean_pre_pad, pix_k)
    du = dot3(d_oct, _gather_rows(torch.cat([u, pad], dim=1), pix_k))
    dv = dot3(d_oct, _gather_rows(torch.cat([v, pad], dim=1), pix_k))
    p2 = torch.stack([du, dv], dim=-1)  # (S, N, 2) in-plane coordinates
    dots = torch.matmul(p2, torch.tensor(_OCT_DIRS, dtype=torch.float32, device=dev).T)  # (S, N, 8)
    dots_m = torch.where(in_sel[..., None], dots, torch.full((), float("-inf"), device=dev))
    slot8 = pix_k[..., None].expand(-1, -1, 8)
    M = torch.full((s, K + 1, 8), float("-inf"), device=dev).scatter_reduce(1, slot8, dots_m, reduce="amax")
    m_here = torch.gather(M, 1, slot8)
    witness = in_sel[..., None] & (dots >= m_here - 1e-6)
    # one well-defined witness pixel per (label, direction): the max index
    pidx = torch.arange(hw, dtype=torch.int64, device=dev)[None, :, None]
    wit_idx = torch.where(witness, pidx, -1)
    widx = torch.full((s, K + 1, 8), -1, dtype=torch.int64, device=dev).scatter_reduce(
        1, slot8, wit_idx, reduce="amax")[:, :K]
    wsafe = torch.clamp(widx, 0, hw - 1).reshape(s, K * 8)
    verts = _gather_rows(p2, wsafe).reshape(s, K, 8, 2)
    # empty labels: the octagon collapses to the origin (all candidates)
    verts = torch.where((widx >= 0)[..., None], verts, zero)

    # point-in-octagon (strict, with a conservative margin): CCW edge walk
    verts_pad = torch.cat([verts, torch.zeros((s, 1, 8, 2), device=dev)], dim=1).reshape(s, K + 1, 16)
    vt = _gather_rows(verts_pad, pix_k).reshape(s, hw, 8, 2)
    e = torch.roll(vt, -1, dims=2) - vt  # octagon edges
    rel = p2[:, :, None, :] - vt
    cross = e[..., 0] * rel[..., 1] - e[..., 1] * rel[..., 0]
    nondeg = (e * e).sum(-1) > 1e-18
    inside = (~nondeg | (cross > _OCT_EPS)).all(-1) & nondeg.any(-1)
    candidate = (in_sel & ~inside).reshape(s, h, w)

    # hue histogram + color sums
    hue = _hue_bins(rgb_bgr).reshape(s, hw).to(torch.int64)
    ones = in_sel.to(torch.float32)[..., None]
    hist = _bin_sum(pix_k * HIST_H_BINS + hue, ones, (K + 1) * HIST_H_BINS).reshape(s, K + 1, HIST_H_BINS)[:, :K]
    rgb = rgb_bgr.reshape(s, hw, 3).flip(-1).to(torch.float32)
    rgb = torch.where(in_sel[..., None], rgb, zero)
    sum_rgb = _bin_sum(pix_k, rgb, K + 1)[:, :K]

    return SensorPlaneStats(
        labels=labels, candidate=candidate, label_id=topi, count=count, mean=mean, cov=cov,
        evals=evals, normal=normal, curvature=curvature, hist=hist, sum_rgb=sum_rgb, mean_pre=mean_pre,
    )
