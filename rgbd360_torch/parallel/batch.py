"""Batched pair registration — the unit of scale-out.

Counterpart of rgbd360_tpu/parallel/batch.py. The JAX package vmaps one
pair's registration over a leading axis (batch.py:45); the port's ops carry
the pair axis B throughout, so ``align_batch`` is ``photoicp.align_spheres``
on B pairs of panoramas, and ``align_batch_rig`` is
``photoicp_pinhole.register_dense_photoicp`` on B pairs of raw 8-sensor
frames: one pyramid build for all B sources, one for all B targets, then
one coarse-to-fine Gauss-Newton loop whose every sweep covers the whole batch.
"""

from __future__ import annotations

import torch

from rgbd360_torch.ops import photoicp, photoicp_pinhole


def align_batch(
    gray_src: torch.Tensor,  # (B, H, W) f32
    depth_src: torch.Tensor,  # (B, H, W) f32 metres
    gray_trg: torch.Tensor,
    depth_trg: torch.Tensor,
    pose_guess: torch.Tensor,  # (B, 4, 4)
    method: int = photoicp.PHOTO_DEPTH,
    n_levels: int = 5,
    need_stats: bool = True,
    full_coverage: bool = False,
) -> photoicp.AlignResult:
    """Register B independent pairs (batch.py:31). Every field of the
    returned AlignResult leads with the pair axis."""
    return photoicp.align_spheres(
        gray_src, depth_src, gray_trg, depth_trg, pose_guess, method, n_levels,
        need_stats=need_stats, full_coverage=full_coverage,
    )


def align_batch_rig(
    gray_src: torch.Tensor,  # (B, C, H, W) f32: the raw sensors of each pair's source frame
    depth_src: torch.Tensor,  # (B, C, H, W) f32 metres (raw depth)
    gray_trg: torch.Tensor,
    depth_trg: torch.Tensor,
    cam_rts: torch.Tensor,  # (C, 4, 4) f32 sensor extrinsics (robot from camera)
    k: torch.Tensor,  # (3, 3) the sensors' camera matrix
    pose_guess: torch.Tensor,  # (B, 4, 4)
    method: int = photoicp.PHOTO_DEPTH,
    n_levels: int = 4,
) -> photoicp_pinhole.PinholeAlignResult:
    """Register B independent pairs of rig frames in the robot frame
    (RegisterDensePhotoICP, RegisterRGBD360.h:344-516), each pair's C
    sensors through their extrinsics. Every field of the returned
    PinholeAlignResult leads with the pair axis."""
    return photoicp_pinhole.register_dense_photoicp(
        gray_src, depth_src, gray_trg, depth_trg, cam_rts, k, pose_guess, method, n_levels,
    )
