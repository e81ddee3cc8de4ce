"""The reference's entry points and the precision of its control.

``align`` registers B pairs with the frozen aligner (photoicp.py) and
returns what the program's AlignResult holds, on the host; ``optimize``
runs the frozen pose-graph optimizer (graph.py) from a recorded state.
``precision(lower=True)`` computes both one step below what the
configurations state: float32 matmuls in TF32 (the program turns TF32
off, rgbd360_torch/__init__.py) and the pose graph in float32 for float64.
That is the correctness check's control.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import graph, photoicp

PHOTO_DEPTH = photoicp.PHOTO_DEPTH
N_LEVELS = 5  # alignFrames360's pyramid (RegisterPhotoICP.h:4519), both configurations


@contextlib.contextmanager
def precision(lower: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, graph.FLOAT)
    torch.backends.cuda.matmul.allow_tf32 = lower
    graph.FLOAT = np.float32 if lower else np.float64
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, graph.FLOAT = saved


def align(gray_src, depth_src, gray_trg, depth_trg, guesses, full_coverage: bool) -> dict:
    """B pairs: images (B, H, W) f32 (depth in metres) on one device,
    guesses (B, 4, 4). Returns numpy arrays: pose (B, 4, 4), error,
    av_photo, av_depth, sso (B,), iters (B, 5), ill (B,)."""
    guess = torch.as_tensor(np.asarray(guesses, np.float32), device=gray_src.device)
    res = photoicp.align_spheres(gray_src, depth_src, gray_trg, depth_trg, guess, photoicp.PHOTO_DEPTH,
                                 N_LEVELS, full_coverage=full_coverage)
    return {
        "pose": res.pose.cpu().numpy(), "error": res.error.cpu().numpy(),
        "av_photo": res.av_photo_residual.cpu().numpy(), "av_depth": res.av_depth_residual.cpu().numpy(),
        "sso": res.sso.cpu().numpy(), "iters": res.num_iterations.cpu().numpy(),
        "ill": res.ill_posed.cpu().numpy(),
    }


def optimize(vertices, edges, iterations: int, lam: float, robust: bool) -> list:
    """Run optimize_graph once from ``vertices`` (4 x 4 poses) and ``edges``
    ((i, j, z, info) each). Returns the optimized poses."""
    g = graph.GraphOptimizer(robust=robust)
    for v in vertices:
        g.add_vertex(v)
    for i, j, z, info in edges:
        g.add_edge(i, j, z, info)
    g.optimize_graph(iterations, lam)
    return g.get_poses()
