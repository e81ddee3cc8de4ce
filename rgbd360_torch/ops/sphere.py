"""Spherical geometry of the 1920x320 panorama.

Counterpart of rgbd360_tpu/ops/sphere.py. Pixel <-> 3D convention
(reference include/Frame360.h:589-592, include/RegisterPhotoICP.h:4580-4582):
    phi   = (0.5*H - 0.5 - row) * angle_res,   angle_res = 2*pi/W
    theta = col * angle_res
    x = d*sin(phi);  y = -d*cos(phi)*sin(theta);  z = -d*cos(phi)*cos(theta)
and the forward projection of the dense aligner
(reference include/RegisterPhotoICP.h:2675-2680):
    dist = |p|;  phi' = asin(x/dist);  theta' = atan2(y, z) + pi
    row' = round(0.5*H-0.5 - phi'/angle_res);  col' = round(theta'/angle_res)
``sphere_cloud_from_image`` (sphere.py:64) is the colored cloud of a
stitched panorama (frame assembly).
"""

from __future__ import annotations

import math

import torch

from rgbd360_torch.ops.image import round_half_away


def sphere_xyz_lut(depth: torch.Tensor, min_depth: float, max_depth: float):
    """Spherical backprojection of (..., H, W) depth (sphere.py:21; reference
    RegisterPhotoICP.h:4553-4587). Returns xyz (..., H*W, 3) with invalid
    points zeroed and valid (..., H*W) bool."""
    h, w = depth.shape[-2], depth.shape[-1]
    angle_res = 2.0 * math.pi / w
    row = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    col = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    phi = (0.5 * h - 0.5 - row) * angle_res
    theta = col * angle_res
    sin_phi = torch.sin(phi)
    cos_phi = torch.cos(phi)
    x = depth * sin_phi
    y = -depth * cos_phi * torch.sin(theta)
    z = -depth * cos_phi * torch.cos(theta)
    valid = (depth > min_depth) & (depth < max_depth)
    lead = depth.shape[:-2]
    xyz = torch.stack([x, y, z], dim=-1).reshape(lead + (h * w, 3))
    valid = valid.reshape(lead + (h * w,))
    return torch.where(valid[..., None], xyz, torch.zeros_like(xyz)), valid


def sphere_project(p: torch.Tensor, h: int, w: int):
    """Project (..., N, 3) points onto the panorama grid (sphere.py:45).
    Returns (dist, row_int, col_int, inbounds). The theta == 2*pi column W
    is dropped, not wrapped, as the reference does (RegisterPhotoICP.h:2684)."""
    angle_res_inv = w / (2.0 * math.pi)
    half_rows = 0.5 * h - 0.5
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    dist = torch.sqrt(px * px + py * py + pz * pz)
    safe = torch.clamp(dist, min=1e-12)
    phi = torch.arcsin(torch.clamp(px / safe, -1.0, 1.0))
    theta = torch.atan2(py, pz) + math.pi
    r_int = round_half_away(half_rows - phi * angle_res_inv).to(torch.int32)
    c_int = round_half_away(theta * angle_res_inv).to(torch.int32)
    inb = (r_int >= 0) & (r_int < h) & (c_int >= 0) & (c_int < w)
    return dist, r_int, c_int, inb


def sphere_cloud_from_image(sphere_rgb: torch.Tensor, sphere_depth_m: torch.Tensor):
    """Colored spherical point cloud from the stitched panorama (sphere.py:64;
    reference include/Frame360.h:555-612 buildSphereCloud_fromImage).

    This variant uses an offset phi grid (31.5 deg top, 1/angle_pixel
    spacing) rather than the aligner's half-pixel-centred grid, as the
    reference does. Invalid (zero-depth) points become NaN. Returns xyz
    (H, W, 3) f32 and rgb (H, W, 3) u8 (the BGR panorama reversed)."""
    h, w = sphere_depth_m.shape
    dev = sphere_depth_m.device
    angle_pixel_inv = 2.0 * math.pi / w
    offset_phi = math.pi * 31.5 / 180.0
    row = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    col = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    phi = offset_phi - row * angle_pixel_inv
    theta = col * angle_pixel_inv
    d = sphere_depth_m
    x = torch.sin(phi) * d
    y = -torch.cos(phi) * torch.sin(theta) * d
    z = -torch.cos(phi) * torch.cos(theta) * d
    nan = torch.full((), float("nan"), device=dev)
    invalid = d == 0
    xyz = torch.stack([torch.where(invalid, nan, x), torch.where(invalid, nan, y), torch.where(invalid, nan, z)], dim=-1)
    return xyz, torch.flip(sphere_rgb, dims=(-1,))
