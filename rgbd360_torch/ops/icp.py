"""Point-to-plane ICP on spherical panoramas — the stand-in for the PCL GICP
calls of the reference (Registration/RegisterPairRGBD360.cpp:112-142 and
RegisterPhotoICP::alignPyramidICP, include/RegisterPhotoICP.h:4799-4860:
max correspondence 0.3 m, 10 iterations, transformation epsilon 1e-6).

Counterpart of rgbd360_tpu/ops/icp.py. Correspondences use the panorama's
projective structure, not a KD-tree: a source point transformed by the
current pose is matched to the target point stored at its projected pixel,
with point-to-plane residuals from the target's organized normals. Runs on
its tensors' device; the ``lax.while_loop`` is a host loop with one sync per
iteration (the update norm), and the 6x6 system is summed per image row
(photoicp._normal_equations) in full f32, as the JAX HIGHEST matmuls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rgbd360_torch.ops import linalg6, se3
from rgbd360_torch.ops.photoicp import _normal_equations
from rgbd360_torch.ops.sphere import sphere_project, sphere_xyz_lut

MAX_CORRESPONDENCE = 0.3
MAX_ITERS = 10
TRANSFORM_EPS = 1e-6
MIN_DEPTH = 0.3  # the ICP's own depth range (icp.py:71-72)
MAX_DEPTH = 10.0


class ICPResult(NamedTuple):
    pose: torch.Tensor  # (4, 4)
    fitness: torch.Tensor  # () mean squared point-to-plane distance of the inliers
    num_inliers: torch.Tensor  # () i64
    num_iterations: int


def _target_normals_sphere(xyz_t: torch.Tensor, valid_t: torch.Tensor, h: int, w: int):
    """Organized normals of the target panorama cloud by central differences
    and a cross product (icp.py:37): a normal only where all four neighbours
    are valid; theta columns wrap, rows do not. Returns (normals (N, 3),
    normal_ok (N,) bool)."""
    p = xyz_t.reshape(h, w, 3)
    v = valid_t.reshape(h, w)
    dx = torch.roll(p, -1, dims=1) - torch.roll(p, 1, dims=1)  # theta wraps
    vx = torch.roll(v, -1, dims=1) & torch.roll(v, 1, dims=1)
    up = torch.cat([p[:1], p[:-1]], dim=0)  # clamped, no wrap
    dn = torch.cat([p[1:], p[-1:]], dim=0)
    dy = dn - up
    vy = torch.cat([v[:1], v[:-1]], dim=0) & torch.cat([v[1:], v[-1:]], dim=0)
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ok = (v & vx & vy & (norm[..., 0] > 1e-12)).reshape(-1)
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(n * p, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n).reshape(-1, 3), ok


def icp_point_to_plane_sphere(
    depth_src_m: torch.Tensor,  # (H, W) f32
    depth_trg_m: torch.Tensor,
    pose_guess: torch.Tensor,  # (4, 4)
    max_iters: int = MAX_ITERS,
) -> ICPResult:
    """Projective point-to-plane ICP of the source panorama onto the target
    (icp.py:64). The fitness and inlier count are evaluated at the returned
    pose."""
    h, w = depth_src_m.shape
    xyz_s, valid_s = sphere_xyz_lut(depth_src_m, MIN_DEPTH, MAX_DEPTH)
    xyz_t, valid_t = sphere_xyz_lut(depth_trg_m, MIN_DEPTH, MAX_DEPTH)
    normals_t, normal_ok_t = _target_normals_sphere(xyz_t, valid_t, h, w)
    target_ok = valid_t & normal_ok_t
    eye6 = torch.eye(6, dtype=torch.float32, device=depth_src_m.device)

    def step(pose):
        p = xyz_s @ pose[:3, :3].T + pose[:3, 3]
        _dist, r_i, c_i, inb = sphere_project(p, h, w)
        flat = (torch.clamp(r_i, 0, h - 1) * w + torch.clamp(c_i, 0, w - 1)).long()
        q, n = xyz_t[flat], normals_t[flat]
        diff = p - q
        d2 = torch.sum(diff * diff, dim=-1)
        ok = valid_s & inb & target_ok[flat] & (d2 < MAX_CORRESPONDENCE**2)
        r = torch.sum(diff * n, dim=-1)  # point-to-plane residual
        jac = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)  # [n^T | (p x n)^T]
        jac = torch.where(ok[:, None], jac, torch.zeros_like(jac))
        r_m = torch.where(ok, r, torch.zeros_like(r))
        H, g = _normal_equations(jac[None], r_m[None], (h, w))
        n_ok = ok.sum()
        fitness = torch.sum(r_m * r_m) / torch.clamp(n_ok, min=1)
        return H[0], g[0], fitness, n_ok

    pose = pose_guess.to(torch.float32)
    it = 0
    upd = np.float32(1.0)
    while it < max_iters and upd > np.float32(TRANSFORM_EPS):
        H, g, _fit, _n = step(pose)
        x, ok = linalg6.solve6_sym(H + 1e-6 * eye6, g)
        update = torch.where(ok, -x, torch.zeros_like(x))  # a failed solve ends the loop
        pose = se3.exp_se3(update, pseudo=False) @ pose
        it += 1
        upd = torch.linalg.vector_norm(update).cpu().numpy()
    _H, _g, fitness, n_ok = step(pose)
    return ICPResult(pose=pose, fitness=fitness, num_inliers=n_ok, num_iterations=it)
