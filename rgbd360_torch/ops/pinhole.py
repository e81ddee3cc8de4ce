"""Pinhole backprojection of the per-sensor depth images.

Counterpart of ``backproject_organized`` in rgbd360_tpu/ops/pinhole.py
(reference OpenNI2_Grabber/FrameRGBD/CloudRGBD_Ext.h:85-135): f = 525*w/640,
cx = w/2-0.5, cy = h/2-0.5; valid depth in [0.3, 10.0] m, invalid points
NaN. The median downsampling of that module belongs to the plane layer
(ROADMAP queue 1, slice 3).
"""

from __future__ import annotations

import torch

MIN_DEPTH = 0.3
MAX_DEPTH = 10.0


def backproject_organized(depth_m: torch.Tensor) -> torch.Tensor:
    """(..., H, W) f32 metres -> (..., H, W, 3) f32 organized cloud, NaN
    where invalid (pinhole.py:27; the JAX function takes one (H, W) image
    and is vmapped over the sensors)."""
    h, w = depth_m.shape[-2], depth_m.shape[-1]
    dev = depth_m.device
    focal = 525.0 * w / 640.0
    inv_f = 1.0 / focal
    ox = w / 2 - 0.5
    oy = h / 2 - 0.5
    x_img = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    y_img = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    z = depth_m
    valid = (z > 0) & (z >= MIN_DEPTH) & (z <= MAX_DEPTH)
    x = (x_img - ox) * z * inv_f
    y = (y_img - oy) * z * inv_f
    nan = torch.full((), float("nan"), device=dev)
    return torch.stack([torch.where(valid, x, nan), torch.where(valid, y, nan), torch.where(valid, z, nan)], dim=-1)
