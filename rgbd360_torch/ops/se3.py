"""SE(3)/SO(3) helpers on batched f32 tensors.

Counterpart of rgbd360_tpu/ops/se3.py. The spherical aligner composes pose
updates as ``exp(xi) @ pose`` with the mrpt pseudo-exponential
(translation copied verbatim, rotation exponentiated) — reference
include/RegisterPhotoICP.h:4697; the full SE(3) exponential is the
reference's pinhole form (include/RegisterPhotoICP.h:4358). Every function
takes any leading batch shape.
"""

from __future__ import annotations

import math

import torch

from rgbd360_torch.utils import timing


def skew(v: torch.Tensor) -> torch.Tensor:
    """Hat operator: skew(v) @ u == v x u (reference
    include/Miscellaneous.h:88-99; rgbd360_tpu/ops/se3.py:17)."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def _one(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with Taylor fallbacks near 0 (se3.py:31)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-6
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.where(small, _one(theta), theta))
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.where(small, _one(theta2), theta2)
    )
    W = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _to_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = timing.to_device([0.0, 0.0, 0.0, 1.0], R.dtype, R.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def exp_se3(xi: torch.Tensor, pseudo: bool = True) -> torch.Tensor:
    """4x4 pose from twist [v, w] (se3.py:46). pseudo=True: t = v."""
    v, w = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    if pseudo:
        t = v
    else:
        theta2 = torch.sum(w * w, dim=-1)
        theta = torch.sqrt(theta2)
        small = theta < 1e-6
        b = torch.where(
            small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.where(small, _one(theta2), theta2)
        )
        c = torch.where(
            small,
            1.0 / 6.0 - theta2 / 120.0,
            (theta - torch.sin(theta)) / torch.where(small, _one(theta), theta2 * theta),
        )
        W = skew(w)
        eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
        V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
        t = (V @ v[..., None])[..., 0]
    return _to_pose(R, t)


def _trace3(R: torch.Tensor) -> torch.Tensor:
    return R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector from a rotation matrix (se3.py:79), batched."""
    cos_theta = torch.clamp((_trace3(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_hat = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    small = theta < 1e-6
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.sin(torch.where(small, _one(theta), theta))),
    )
    return scale[..., None] * w_hat


def compose(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    return pose_a @ pose_b


def inverse(pose: torch.Tensor) -> torch.Tensor:
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    return _to_pose(Rt, ti)


def rot_angle_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angular distance between rotations in degrees (reference
    include/Miscellaneous.h:127-140 diffRotation; se3.py:105)."""
    Rrel = Ra.transpose(-1, -2) @ Rb
    cos_theta = torch.clamp((_trace3(Rrel) - 1.0) * 0.5, -1.0, 1.0)
    return torch.arccos(cos_theta) * (180.0 / math.pi)
