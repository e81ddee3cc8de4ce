"""Batched pair registration — the unit of scale-out.

Counterpart of rgbd360_tpu/parallel/batch.py. The JAX package vmaps one
pair's registration over a leading axis (batch.py:45); the port's ops carry
the pair axis B throughout, so ``align_batch`` is ``photoicp.align_spheres``
on B pairs: one pyramid build for all B sources, one for all B targets, then
one coarse-to-fine Gauss-Newton loop whose every sweep covers the whole batch.
"""

from __future__ import annotations

import torch

from rgbd360_torch.ops import photoicp


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
