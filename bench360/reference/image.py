"""Frozen copy of rgbd360_torch/ops/image.py for the benchmark's reference;
imports nothing of the program. The original's notes follow.

Image-space ops: gray conversion, Gaussian pyramids, valid-aware depth
pyramids and the weighted first-order ("Jaimez") gradients.

Counterpart of rgbd360_tpu/ops/image.py. Every function works on the last
two axes, (..., H, W), so a batch of panoramas goes through in one call.
The arithmetic follows the JAX functions operation by operation (same
operand order in each sum) so the pyramids agree to the last ulp.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C's round(): halfway cases away from zero (image.py:17).
    torch.round rounds half to even, which differs on +-k.5."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def bgr_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """OpenCV CV_RGB2GRAY on a stored-BGR uint8 image, fixed point, exactly
    as the reference (include/RegisterPhotoICP.h:485; image.py:22)."""
    img = img.to(torch.int32)
    gray = (img[..., 0] * 4899 + img[..., 1] * 9617 + img[..., 2] * 1868 + (1 << 13)) >> 14
    return gray.to(torch.uint8)


def gray_f32(img_bgr_u8: torch.Tensor) -> torch.Tensor:
    """uint8 BGR -> float gray in [0,1] (RegisterPhotoICP.h:485-486)."""
    return bgr_to_gray_u8(img_bgr_u8).to(torch.float32) * (1.0 / 255.0)


# 5-tap binomial kernel of cv::pyrDown (image.py:38), as f32 scalars
_PYR_KERNEL = [float(v) for v in np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0]


@functools.lru_cache(maxsize=None)
def _reflect101_index(n: int, pad: int) -> np.ndarray:
    """Indices of OpenCV BORDER_REFLECT_101 padding (gfedcb|abcdefgh|gfedcba)."""
    return np.pad(np.arange(n), pad, mode="reflect")


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown: 5x5 Gaussian blur (reflect-101 border), then keep even
    rows/cols with FLOOR sizes (RegisterPhotoICP.h:292-308; image.py:46)."""
    x = img.to(torch.float32)
    h, w = x.shape[-2], x.shape[-1]
    ri = torch.from_numpy(_reflect101_index(h, 2)).to(x.device)
    xp = x.index_select(-2, ri)
    acc = 0
    for i in range(5):
        acc = acc + _PYR_KERNEL[i] * xp[..., i : i + h, :]
    x = acc
    ci = torch.from_numpy(_reflect101_index(w, 2)).to(x.device)
    xp = x.index_select(-1, ci)
    acc = 0
    for i in range(5):
        acc = acc + _PYR_KERNEL[i] * xp[..., :, i : i + w]
    return acc[..., : 2 * (h // 2) : 2, : 2 * (w // 2) : 2]


def build_gray_pyramid(gray: torch.Tensor, n_levels: int) -> list:
    pyr = [gray]
    for _ in range(1, n_levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def depth_down_valid(depth: torch.Tensor, min_depth: float, max_depth: float) -> torch.Tensor:
    """Valid-aware 2x2 averaging, zero where no sample is in range
    (reference RegisterPhotoICP.h:312-354 buildPyramidRange; image.py:71)."""
    h, w = depth.shape[-2], depth.shape[-1]
    lead = depth.shape[:-2]
    blocks = depth[..., : h - h % 2, : w - w % 2].reshape(lead + (h // 2, 2, w // 2, 2))
    valid = (blocks > min_depth) & (blocks < max_depth)
    vals = torch.where(valid, blocks, torch.zeros_like(blocks))
    # row-major sequential order: XLA's reduce over axes (1, 3) sums the
    # four samples in this order, so the levels agree bit for bit
    s = ((vals[..., 0, :, 0] + vals[..., 0, :, 1]) + vals[..., 1, :, 0]) + vals[..., 1, :, 1]
    n = valid.to(torch.int32).sum(dim=(-3, -1))
    return torch.where(n > 0, s / torch.clamp(n, min=1).to(torch.float32), torch.zeros_like(s))


def build_depth_pyramid(depth_m: torch.Tensor, n_levels: int, min_depth: float, max_depth: float) -> list:
    pyr = [depth_m]
    for _ in range(1, n_levels):
        pyr.append(depth_down_valid(pyr[-1], min_depth, max_depth))
    return pyr


def _grad(prev, cur, nxt):
    d1 = nxt - cur
    d0 = cur - prev
    monotone = ((cur > nxt) & (cur < prev)) | ((cur < nxt) & (cur > prev))
    g = 2.0 * d1 * d0 / (d0 + d1)
    return torch.where(monotone, g, torch.zeros_like(g))


def gradient_xy(src: torch.Tensor):
    """Weighted first-order gradient (reference RegisterPhotoICP.h:365-398;
    image.py:90): harmonic mean of the one-sided differences where the
    pixel is strictly monotone, zero elsewhere and on the 1-pixel border."""
    gx_core = _grad(src[..., 1:-1, :-2], src[..., 1:-1, 1:-1], src[..., 1:-1, 2:])
    gy_core = _grad(src[..., :-2, 1:-1], src[..., 1:-1, 1:-1], src[..., 2:, 1:-1])
    gx = torch.nn.functional.pad(gx_core, (1, 1, 1, 1))
    gy = torch.nn.functional.pad(gy_core, (1, 1, 1, 1))
    return gx, gy


@functools.lru_cache(maxsize=None)
def _seam_mask(w: int, num_sensors: int) -> np.ndarray:
    width_sensor = w // num_sensors
    mask = np.ones((1, w), np.float32)
    for s in range(1, num_sensors):
        mask[0, s * width_sensor - 1 : s * width_sensor + 1] = 0.0
    return mask


def mask_sensor_seams(grad: torch.Tensor, num_sensors: int = 8) -> torch.Tensor:
    """Zero the 2-pixel columns at the sensor joints (reference
    RegisterPhotoICP.h:4537-4549; image.py:122). A multiply, as in JAX, so
    negative gradients there become -0.0 — the warp gather carries those
    bits through unchanged."""
    mask = torch.from_numpy(_seam_mask(grad.shape[-1], num_sensors)).to(grad.device)
    return grad * mask
