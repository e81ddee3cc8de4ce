"""Pinhole backprojection + valid-aware downsampling of the per-sensor
organized point clouds (the inputs to plane segmentation).

Counterpart of rgbd360_tpu/ops/pinhole.py. Reference semantics:
  * backprojection (OpenNI2_Grabber/FrameRGBD/CloudRGBD_Ext.h:85-135):
    f = 525*w/640, cx = w/2-0.5, cy = h/2-0.5; valid depth in [0.3, 10.0] m,
    invalid points NaN;
  * 2x downsampling (OpenNI2_Grabber/FrameRGBD/DownsampleRGBD.h:209-305):
    per 2x2 block, each coordinate is the *independent median* (element
    n//2 of the sorted valid samples, valid = finite with z in (0.3, 5.0));
    color comes from the block's lower-right (center) pixel; a block with no
    valid samples copies the center point verbatim (usually NaN).

The JAX functions take one sensor and are vmapped; these take any leading
batch axes (the 8 sensors).
"""

from __future__ import annotations

import torch

MIN_DEPTH = 0.3
MAX_DEPTH = 10.0
DOWNSAMPLE_MIN_DEPTH = 0.3
DOWNSAMPLE_MAX_DEPTH = 5.0


def backproject_organized(depth_m: torch.Tensor) -> torch.Tensor:
    """(..., H, W) f32 metres -> (..., H, W, 3) f32 organized cloud, NaN
    where invalid (pinhole.py:27)."""
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


def _median_of_block(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """vals/valid: (..., 4). Per-coordinate median as sorted_valid[n//2]:
    a 4-element min/max sorting network and a select on n//2
    (pinhole.py:47)."""
    big = torch.where(valid, vals, torch.full((), float("inf"), device=vals.device))
    v0, v1, v2, v3 = big.unbind(-1)
    a, b = torch.minimum(v0, v1), torch.maximum(v0, v1)
    c, d = torch.minimum(v2, v3), torch.maximum(v2, v3)
    lo = torch.minimum(a, c)
    m1 = torch.minimum(torch.maximum(a, c), torch.minimum(b, d))
    m2 = torch.maximum(torch.maximum(a, c), torch.minimum(b, d))
    hi = torch.maximum(b, d)
    idx = valid.sum(-1) // 2
    return torch.where(idx == 0, lo, torch.where(idx == 1, m1, torch.where(idx == 2, m2, hi)))


def downsample_median2(xyz: torch.Tensor, rgb: torch.Tensor):
    """2x 'median' downsample of an organized cloud + nearest color
    (pinhole.py:67).

    xyz: (..., H, W, 3) with NaN invalid; rgb: (..., H, W, 3) uint8.
    Returns (xyz_half (..., H/2, W/2, 3), rgb_half).
    """
    *lead, h, w, _ = xyz.shape
    blocks = xyz.reshape(*lead, h // 2, 2, w // 2, 2, 3)
    n = len(lead)
    # (..., h/2, 2, w/2, 2, 3) -> (..., h/2, w/2, 3, 2, 2) -> (..., 3, 4)
    blocks = blocks.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3).reshape(*lead, h // 2, w // 2, 3, 4)
    z = blocks[..., 2, :]
    valid = torch.isfinite(blocks[..., 0, :]) & (z > DOWNSAMPLE_MIN_DEPTH) & (z < DOWNSAMPLE_MAX_DEPTH)
    med = torch.stack([_median_of_block(blocks[..., c, :], valid) for c in range(3)], dim=-1)
    center = xyz[..., 1::2, 1::2, :]  # block center pixel (r+1, c+1)
    any_valid = valid.any(-1)
    out = torch.where(any_valid[..., None], med, center)
    return out, rgb[..., 1::2, 1::2, :]
