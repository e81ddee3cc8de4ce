"""Batched plane-compatibility prefilter on the device.

Counterpart of rgbd360_tpu/core/batch_match.py. Relocalization and
loop-closure candidate evaluation are batched (SURVEY.md §2.3): every
candidate keyframe's unary plane-compatibility matrix is evaluated in one
device call, and the exact host interpretation-tree search runs only on
the candidates whose compatibility upper bound clears the acceptance gates
(the reference scans the keyframes one by one, Relocalizer360.h:78-93).

The prefilter is a strict relaxation of SubgraphMatcher._unary (it drops
the label-equality constraint and never adds one), so a candidate the exact
matcher would accept always survives it, and results equal the sequential
scan.

``pack_pbmap`` and ``stack_packs`` stay on the host (copies). The JAX
package vmaps ``_compat_matrix`` over the candidates (batch_match.py:148);
here ``compat_matrices`` is one broadcast (B, Kf, Kc) evaluation on the
caller's device, fed by one upload of the packed planes and read by one
read-back of the per-plane "has a compatible partner" flags. The counts and
areas are then summed on the host in numpy, as JAX does.

The Bhattacharyya coefficient and the normals' cosine are f32 products with
TF32 off (the package sets full f32 matmuls): ``bc >= hue_thr`` is a
threshold that TF32's 10-bit mantissa would move. Their summation order is
torch's, not XLA's, so a value within an ulp or so of a threshold may fall
on the other side (tests/test_torch_slam.py holds the matrices equal on
values placed 1e-3 from each threshold and names the cases that sit within
1e-6).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from rgbd360_torch.config import default_params
from rgbd360_torch.core.matcher import (
    ODOMETRY_6DOF,
    PLANAR_3DOF,
    PLANAR_ODOMETRY_3DOF,
    MatcherConfig,
)
from rgbd360_torch.core.pbmap import HIST_H_BINS, PbMap
from rgbd360_torch.device import resolve_device

MAX_PLANES = 48  # pad bound for one keyframe's plane set
_KEYS = ("normals", "d", "area", "elong", "hist", "has_hist", "valid")
# columns of one packed plane row: normal 3, d, area, elong, hist, has_hist, valid
_COLS = 3 + 3 + HIST_H_BINS + 2


def pack_pbmap(pbmap: PbMap, k: int = MAX_PLANES):
    """Plane parameters as fixed-shape arrays (pad/truncate to k planes).

    Ordering must keep the packed set a SUPERSET of the exact matcher's
    subgraph selection (RegisterRGBD360._select: curvature-filtered, labeled
    planes force-promoted with area key 10.0, top max_match_planes=25) or
    the 'strict relaxation' guarantee breaks — a plane the tree search would
    match could be truncated out of the prefilter's k=48 and the candidate
    wrongly pruned. So: curvature-passing planes first, then _select's own
    label-forced area key; the exact top-25 is always a prefix."""
    planes = sorted(
        pbmap.planes,
        key=lambda p: (
            p.curvature < default_params.max_curvature_plane,
            10.0 if p.label else p.area_hull,
        ),
        reverse=True,
    )[:k]
    n = len(planes)
    normals = np.zeros((k, 3), np.float32)
    d = np.zeros(k, np.float32)
    area = np.zeros(k, np.float32)
    elong = np.ones(k, np.float32)
    hist = np.zeros((k, HIST_H_BINS), np.float32)
    has_hist = np.zeros(k, bool)
    valid = np.zeros(k, bool)
    for i, p in enumerate(planes):
        normals[i] = p.normal
        d[i] = p.d
        area[i] = p.area_hull
        elong[i] = max(p.elongation, 1.0)
        if p.hist_h is not None and np.sum(p.hist_h) > 0:
            hist[i] = p.hist_h
            has_hist[i] = True
        valid[i] = True
    return dict(
        normals=normals, d=d, area=area, elong=elong, hist=hist,
        has_hist=has_hist, valid=valid, count=n,
    )


def stack_packs(packs: List[dict]):
    return {key: np.stack([p[key] for p in packs]) for key in _KEYS}


def _rows(pack: dict) -> np.ndarray:
    """(..., K, _COLS) f32 rows of packed planes (the flags as 0/1)."""
    return np.concatenate(
        [pack["normals"], pack["d"][..., None], pack["area"][..., None], pack["elong"][..., None],
         pack["hist"], pack["has_hist"][..., None].astype(np.float32), pack["valid"][..., None].astype(np.float32)],
        axis=-1,
    ).astype(np.float32)


def _fields(rows: torch.Tensor) -> dict:
    """The packed fields of (..., K, _COLS) rows, on the rows' device."""
    h0 = 6
    return dict(
        normals=rows[..., 0:3], d=rows[..., 3], area=rows[..., 4], elong=rows[..., 5],
        hist=rows[..., h0:h0 + HIST_H_BINS], has_hist=rows[..., h0 + HIST_H_BINS] != 0,
        valid=rows[..., h0 + HIST_H_BINS + 1] != 0,
    )


def compat_matrices(ref: dict, trg: dict, cfg: Tuple[float, ...], mode: int) -> torch.Tensor:
    """(B, Kr, Kt) unary compatibility of one reference plane set (fields
    (Kr, ...)) against B candidate sets (fields (B, Kt, ...)); the JAX
    ``_compat_matrix`` (batch_match.py:88) over the candidate axis.

    cfg = (area_threshold, elongation_threshold, hue_threshold, dist_d,
    cos_angle_min); each compared in f32, as the traced JAX scalars."""
    area_thr, elong_thr, hue_thr, dist_d, cos_angle_min = cfg
    a1 = torch.clamp(ref["area"][None, :, None], min=1e-6)
    a2 = torch.clamp(trg["area"][:, None, :], min=1e-6)
    ok = torch.maximum(a1, a2) / torch.minimum(a1, a2) <= area_thr

    e1 = ref["elong"][None, :, None]
    e2 = trg["elong"][:, None, :]
    ok &= torch.maximum(e1, e2) / torch.minimum(e1, e2) <= elong_thr

    # Bhattacharyya coefficient of the hue histograms; pass when either side
    # has no color statistics (the host matcher's None check)
    bc = torch.einsum("ih,bjh->bij", torch.sqrt(ref["hist"]), torch.sqrt(trg["hist"]))
    both = ref["has_hist"][None, :, None] & trg["has_hist"][:, None, :]
    ok &= torch.where(both, bc >= hue_thr, torch.ones_like(both))

    if mode in (ODOMETRY_6DOF, PLANAR_ODOMETRY_3DOF):
        ok &= torch.abs(ref["d"][None, :, None] - trg["d"][:, None, :]) <= dist_d
        cos_ang = torch.einsum("ic,bjc->bij", ref["normals"], trg["normals"])
        ok &= cos_ang >= cos_angle_min
    if mode in (PLANAR_3DOF, PLANAR_ODOMETRY_3DOF):
        up_r = ref["normals"][None, :, None, 0]  # up axis is x (matcher.UP_AXIS)
        up_t = trg["normals"][:, None, :, 0]
        ok &= torch.abs(up_r - up_t) <= 0.1

    return ok & ref["valid"][None, :, None] & trg["valid"][:, None, :]


def config_tuple(config: MatcherConfig) -> Tuple[float, ...]:
    return (
        config.area_threshold,
        config.elongation_threshold,
        config.hue_threshold,
        config.dist_d,
        math.cos(math.radians(config.angle_deg)),
    )


def upload_packs(ref_pack: dict, cand_packs: List[dict], device) -> Tuple[dict, dict]:
    """Packed reference and candidate planes on ``device``, in one upload:
    (ref fields (K, ...), candidate fields (B, K, ...))."""
    rows = np.stack([_rows(ref_pack)] + [_rows(p) for p in cand_packs])
    dev_rows = torch.from_numpy(rows).to(device)
    return _fields(dev_rows[0]), _fields(dev_rows[1:])


def prefilter_candidates(
    frame_pbmap: PbMap,
    cand_pbmaps: List[PbMap],
    config: MatcherConfig,
    mode: int = PLANAR_3DOF,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """For each candidate keyframe: (upper bound on matchable plane count,
    upper bound on the candidate-side matchable area) — one batched
    evaluation on ``device`` (the card unless given). The area bound is over
    the *candidate's* planes because both call sites register with the
    candidate as the reference frame, whose matched area feeds the
    acceptance gate (RegisterRGBD360.get_area_matched)."""
    if not cand_pbmaps:
        return np.zeros(0, int), np.zeros(0)
    cand_packs = [pack_pbmap(p) for p in cand_pbmaps]
    ref, trg = upload_packs(pack_pbmap(frame_pbmap), cand_packs, resolve_device(device))
    compat = compat_matrices(ref, trg, config_tuple(config), mode)  # (B, Kf, Kc)
    has = torch.cat([compat.any(dim=2), compat.any(dim=1)], dim=1).cpu().numpy()  # one read-back
    frame_has, cand_has = has[:, :MAX_PLANES], has[:, MAX_PLANES:]
    counts = np.minimum(frame_has.sum(axis=1), cand_has.sum(axis=1))
    areas = (cand_has * stack_packs(cand_packs)["area"]).sum(axis=1)
    return counts, areas
