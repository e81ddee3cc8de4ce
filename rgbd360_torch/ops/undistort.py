"""Batched CLAMS depth undistortion.

Counterpart of rgbd360_tpu/ops/undistort.py. The reference undistorts the 8
sensors with one OpenMP thread each, walking a per-pixel frustum object tree
(reference include/Frame360.h:293-310 + CLAMS
discrete_depth_distortion_model.cpp:49-70 interpolatedUndistort). Here, as
in JAX, the lookup is gather-free: the spatial binning is a repeat of the
(BY, BX) tables to pixel resolution, and the depth-bin selection a K-term
masked select over the few depth bins (K = 5 for the shipped models), all in
f32 on the tensors' device.
"""

from __future__ import annotations

import torch

# interpolatedUndistort falls back to nearest-bin when either bracketing depth
# bin has fewer than 50 training examples (discrete_depth_distortion_model.cpp:60)
MIN_COUNTS = 50.0


def undistort_depth_mm(
    depth_raw_mm: torch.Tensor,  # (S, H, W) u16 millimetres, 0 = invalid
    multipliers: torch.Tensor,
    counts: torch.Tensor,
    bin_width: int = 4,
    bin_height: int = 3,
    bin_depth: float = 2.0,
) -> torch.Tensor:
    """undistort_depth of the loadDepthEigen u16-mm -> f32-m conversion."""
    return undistort_depth(
        depth_raw_mm.to(torch.float32) * 0.001, multipliers, counts,
        bin_width=bin_width, bin_height=bin_height, bin_depth=bin_depth,
    )


def undistort_depth(
    depth_m: torch.Tensor,  # (S, H, W) f32 metres, 0 = invalid
    multipliers: torch.Tensor,  # (S, BY, BX, K) f32
    counts: torch.Tensor,  # (S, BY, BX, K) f32
    bin_width: int = 4,
    bin_height: int = 3,
    bin_depth: float = 2.0,
) -> torch.Tensor:
    _s, h, w = depth_m.shape
    k = multipliers.shape[-1]

    z = depth_m
    idx = torch.clamp(torch.floor(z / bin_depth), max=k - 1).to(torch.int32)
    start = bin_depth * idx.to(torch.float32)
    idx1 = torch.where(z - start < bin_depth * 0.5, idx, idx + 1)
    idx0 = idx1 - 1

    def expand(plane):  # (S, BY, BX) -> (S, H, W) spatial-bin broadcast
        e = plane.repeat_interleave(bin_height, dim=1).repeat_interleave(bin_width, dim=2)
        return e[:, :h, :w]

    # depth-bin selection as a K-term masked select (no gathers)
    m_near = torch.ones_like(z)
    m0 = torch.ones_like(z)
    m1 = torch.ones_like(z)
    for b in range(k):
        mb = expand(multipliers[..., b])
        m_near = torch.where(idx == b, mb, m_near)
        m0 = torch.where(idx0 == b, mb, m0)
        m1 = torch.where(idx1 == b, mb, m1)
    # counts only matter through the bracketing-pair validity test
    pair_ok = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for b in range(k - 1):
        ok_b = expand((counts[..., b] >= MIN_COUNTS) & (counts[..., b + 1] >= MIN_COUNTS))
        pair_ok = torch.where(idx0 == b, ok_b, pair_ok)

    use_nearest = (idx0 < 0) | (idx1 >= k) | ~pair_ok
    z0 = (idx0.to(torch.float32) + 1.0) * bin_depth - bin_depth * 0.5
    coeff1 = (z - z0) / bin_depth
    # (1 - c) * m0 + c * m1 with the second product fused into the add, as
    # XLA contracts it (one rounding fewer than three separate ops)
    m_interp = torch.addcmul((1.0 - coeff1) * m0, coeff1, m1)
    mult = torch.where(use_nearest, m_near, m_interp)
    return torch.where(z == 0.0, z, z * mult)
