"""Frozen copy of rgbd360_torch/ops/stitch.py for the benchmark's reference;
imports nothing of the program. The original's notes follow.

Spherical panorama stitching as one batched gather.

Counterpart of rgbd360_tpu/ops/stitch.py. The reference warps each sensor's
RGB-D image into its 240-column slice of the 1920x320 panorama with a
per-pixel inverse mapping through the sensor's extrinsic inverse and the
pinhole model, one OpenMP thread per sensor (reference include/Frame360.h:
386-405 stitchSphericalImage, :1098-1148 stitchImage). Here all 8 slices are
one batched gather: panorama (320, 1920) -> (8 blocks, 320, 240), each block
sampling its sensor's (240, 320) images at the nearest (truncated) pixel.

The sampling maps depend on the calibration only, so ``stitch_maps``
computes them once and ``stitch_with_maps`` applies them per frame
(Frame360 caches the maps per Calib360 and device); ``stitch_spherical`` is
the two in one call, as the JAX function.

Parity details kept exactly:
  * panorama block b holds sensor 7-b: columns [b*240, (b+1)*240);
  * theta = (col - 1799.5) * 2*pi/1920, phi = (159.5 - row) * 2*pi/1920, f32;
  * sampling uses C float->int truncation of (u, v);
  * the depth sample (u16 mm) is scaled by the ray obliquity factor
    sqrt(1 + ((u-cx)/fx)^2 + ((v-cy)/fy)^2) computed from *float* (u, v),
    then truncated back to u16 (reference include/Frame360.h:1142);
  * panorama pixels no sensor covers stay 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class StitchMaps(NamedTuple):
    """Per-block sampling of the panorama, each (8, Hs, 240) over block b."""

    sensor: torch.Tensor  # (8,) i64: the sensor of block b, 7 - b
    vi: torch.Tensor  # i32 sensor row, truncated and clipped
    ui: torch.Tensor  # i32 sensor column
    inb: torch.Tensor  # bool: (u, v) inside the sensor image
    obliq: torch.Tensor  # f32 ray obliquity factor from float (u, v)


def stitch_maps(
    Rt_inv: torch.Tensor,  # (8, 4, 4) f32
    camera_matrix: torch.Tensor,  # (3, 3) f32
    size_h: int = 240,
    size_w: int = 320,
    sphere_height: int = 320,
    sphere_width: int = 1920,
) -> StitchMaps:
    """The sampling maps of stitch_spherical (JAX stitch.py:39-88), for all
    8 blocks at once on the device of ``Rt_inv``."""
    num_sensors = Rt_inv.shape[0]
    block_w = size_h  # 240 panorama columns per sensor
    assert sphere_width == num_sensors * block_w
    dev = Rt_inv.device

    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    cx, cy = camera_matrix[0, 2], camera_matrix[1, 2]
    angle_pixel = 2.0 * math.pi / sphere_width
    offset_phi = sphere_height / 2 - 0.5
    offset_theta = -size_h * 15 / 2 + 0.5  # reference include/Frame360.h:1105

    rows = torch.arange(sphere_height, dtype=torch.float32, device=dev)[:, None]
    phi = (offset_phi - rows) * angle_pixel  # (Hs, 1)
    sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)

    block = torch.arange(num_sensors, device=dev)
    sensor = num_sensors - 1 - block  # block b holds sensor 7-b (Frame360.h:1119)
    cols = (block * block_w).to(torch.float32)[:, None, None] + torch.arange(
        block_w, dtype=torch.float32, device=dev
    )[None, None, :]
    theta = (cols + offset_theta) * angle_pixel  # (8, 1, 240)
    vx = sin_phi.expand(sphere_height, block_w)[None]
    vy = cos_phi * torch.sin(theta)
    vz = cos_phi * torch.cos(theta)
    rt = Rt_inv[sensor]
    R = lambda i, j: rt[:, i, j, None, None]
    t = lambda i: rt[:, i, 3, None, None]
    px = R(0, 0) * vx + R(0, 1) * vy + R(0, 2) * vz + t(0)
    py = R(1, 0) * vx + R(1, 1) * vy + R(1, 2) * vz + t(1)
    pz = R(2, 0) * vx + R(2, 1) * vy + R(2, 2) * vz + t(2)
    u = fx * px / pz + cx
    v = fy * py / pz + cy
    inb = (u >= 0) & (u < size_w) & (v >= 0) & (v < size_h)
    ui = torch.clamp(u.to(torch.int32), 0, size_w - 1)
    vi = torch.clamp(v.to(torch.int32), 0, size_h - 1)
    du, dv = (u - cx) / fx, (v - cy) / fy
    obliq = torch.sqrt(1.0 + du * du + dv * dv)
    return StitchMaps(sensor, vi, ui, inb, obliq)


def stitch_with_maps(rgb: torch.Tensor, depth_mm: torch.Tensor, maps: StitchMaps):
    """rgb (8, H, W, 3) u8 BGR, depth_mm (8, H, W) u16 -> (sphere_rgb
    (Hs, Ws, 3) u8, sphere_depth (Hs, Ws) u16)."""
    num_sensors, hs, block_w = maps.vi.shape
    s_idx = maps.sensor[:, None, None]
    bgr = rgb[s_idx, maps.vi, maps.ui]  # (8, Hs, 240, 3)
    bgr = torch.where(maps.inb[..., None], bgr, torch.zeros((), dtype=bgr.dtype, device=bgr.device))
    d = depth_mm.to(torch.int32)[s_idx, maps.vi, maps.ui].to(torch.float32)
    d = torch.where(maps.inb, d * maps.obliq, torch.zeros((), device=d.device))
    d = d.to(torch.int32)  # truncation; d * obliq < 2^16 for depths the sensors report
    # (8, Hs, 240, .) -> (Hs, 1920, .)
    sphere_rgb = bgr.permute(1, 0, 2, 3).reshape(hs, num_sensors * block_w, 3)
    sphere_depth = d.permute(1, 0, 2).reshape(hs, num_sensors * block_w).to(torch.uint16)
    return sphere_rgb.contiguous(), sphere_depth.contiguous()


def stitch_spherical(
    rgb: torch.Tensor,  # (8, H, W, 3) uint8 (BGR)
    depth_mm: torch.Tensor,  # (8, H, W) uint16
    Rt_inv: torch.Tensor,  # (8, 4, 4) f32
    camera_matrix: torch.Tensor,  # (3, 3) f32
    sphere_height: int = 320,
    sphere_width: int = 1920,
):
    """Returns (sphere_rgb (Hs, Ws, 3) u8, sphere_depth (Hs, Ws) u16)."""
    maps = stitch_maps(Rt_inv, camera_matrix, rgb.shape[1], rgb.shape[2], sphere_height, sphere_width)
    return stitch_with_maps(rgb, depth_mm, maps)


def fast_stitch(rgb: torch.Tensor) -> torch.Tensor:
    """fastStitchImage360: concatenate rotated sensor images without the
    spherical warp (reference include/Frame360.h:348-383). Returns a
    (W, 8*H, 3) mosaic: each sensor image transposed then vertically
    flipped, sensors right-to-left."""
    # transpose + flip(0) == rotate 90deg counter-clockwise
    blocks = [torch.flip(rgb[7 - s].transpose(0, 1), dims=(0,)) for s in range(rgb.shape[0])]
    return torch.cat(blocks, dim=1)
