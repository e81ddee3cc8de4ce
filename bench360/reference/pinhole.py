"""The plain reference of the robot-frame dense registration,
RegisterDensePhotoICP (include/RegisterRGBD360.h:344-516 of EduFdez/rgbd360):
one robot pose of one pair of raw 8-sensor frames, solved from every
sensor's pinhole photo and depth residuals through its extrinsics.

One pair at a time, in float32 torch (TF32 off, as the program keeps it;
``api.precision(lower=True)`` turns it on for the control), with no batch
and no cache: the pyramids of photoicp.py (build_pyramid_set with the seam
mask off), the pinhole LUT, the robot-frame sweep with its Jacobian chain,
the damped solve of linalg6.py and the Levenberg-Marquardt loop with its
scalars on the host. Imports nothing of the program.

Where it departs from RegisterRGBD360.h:344-516, and why (the deliberate
deviations that the program's ops/photoicp_pinhole.py names):
  * the behind-camera guard z > 1e-6 in the warp: the reference projects
    points behind a sensor, whose mirrored pixels are no correspondence;
  * the consistent robot depth pair: the depth residual is the target depth
    less the warped point's z in the target sensor, and its Jacobian the
    target depth gradient through the warp less dz/dtwist, the pair that
    differentiates that residual (the reference pairs a residual and a
    Jacobian that do not match);
  * the loop's scalars (lambda, the error drop, the update norm) are f32 on
    the host, as the JAX package's loop carries them, where the reference
    keeps doubles.
Carried over unchanged: nearest-pixel warps with C's round(), the Huber
weights, no saliency gate in the robot frame, lambda0 1e-3 times or over
10 a step, one Levenberg-Marquardt retry of a rejected first step, the
full SE(3) exponential, tolerances 1e-6 (update) and 0.1 (the raw sum of
squares), 10 iterations a level, and an ill-posed level freezing the pose
of every finer one.

The arithmetic is written as the program's: the 3 x 3 products as broadcast
multiplies summed in order, the normal equations as one product per image
row summed over the rows and then the sensors, so that the program and the
reference agree to the bit on the same device.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import linalg6, se3
from .frames import read_capture
from .image import gray_f32, round_half_away
from .photoicp import (
    MAX_DEPTH,
    MIN_DEPTH,
    STD_DEV_DEPTH,
    STD_DEV_PHOTO,
    _exact_gather,
    _huber_weight,
    _matmul_unrolled,
    build_pyramid_set,
    make_level_data,
    pack_target_planes8,
)

N_LEVELS = 4  # RegisterDensePhotoICP's pyramid (RegisterRGBD360.h:383)
MAX_ITERS = 10
TOL_UPDATE = 1e-6
TOL_RESIDUAL = 1e-1
LM_LAMBDA0 = 1e-3
LM_STEP = 10.0


def extrinsics(calib_root: str) -> np.ndarray:
    """(8, 4, 4) f32 sensor poses in the robot frame, as Calib360.h:122-131
    loads them: the f64 file rounded to f32."""
    return np.stack([
        np.loadtxt(os.path.join(calib_root, "Calibration", "Extrinsics", f"Rt_0{s + 1}.txt"),
                   dtype=np.float64).astype(np.float32)
        for s in range(8)
    ])


def sensor_input(path: str, device):
    """(gray (8, 240, 320) f32 in [0, 1], raw depth (8, 240, 320) f32 metres)
    of a capture."""
    rgb, depth = read_capture(path)
    rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(device)
    depth_t = torch.from_numpy(np.ascontiguousarray(depth)).to(device)
    return gray_f32(rgb_t), depth_t.to(torch.float32) * 0.001


def pinhole_lut(depth: torch.Tensor, k: torch.Tensor, level: int):
    """Backprojected (C, H*W, 3) points of (C, H, W) depth at ``level``,
    zero where the depth is out of range, and the (C, H*W) valid mask
    (RegisterPhotoICP.h:4272-4299)."""
    c, h, w = depth.shape
    s = 1.0 / (2**level)
    fx, fy, ox, oy = k[0, 0] * s, k[1, 1] * s, k[0, 2] * s, k[1, 2] * s
    cols = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    rows = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    valid = (depth > MIN_DEPTH) & (depth < MAX_DEPTH)
    xyz = torch.stack([(cols - ox) * depth / fx, (rows - oy) * depth / fy, depth], dim=-1).reshape(c, h * w, 3)
    valid = valid.reshape(c, h * w)
    return torch.where(valid[..., None], xyz, torch.zeros_like(xyz)), valid


def sweep(gray_src, planes, shape, xyz, valid, pose, k, level, cam_rts):
    """Photo and depth error, H and g of one robot pose over the C sensors
    (RegisterPhotoICP.h:4905-5270, calcHessGrad_robot). gray_src (C, N),
    planes (C, H, 8, W), xyz (C, N, 3), valid (C, N), pose (4, 4), cam_rts
    (C, 4, 4). Returns (err2, n, H, g, photo_err2, n_photo, depth_err2,
    n_depth)."""
    h, w = shape
    s = 1.0 / (2**level)
    fx, fy, ox, oy = k[0, 0] * s, k[1, 1] * s, k[0, 2] * s, k[1, 2] * s
    r_cr, t_cr = cam_rts[:, :3, :3], cam_rts[:, None, :3, 3]
    # the point in the source robot frame, moved by the pose, back into the
    # sensor: q = R_cr^-1 (pose (R_cr p + t_cr) - t_cr)
    p_robot = _matmul_unrolled(xyz, r_cr.transpose(-1, -2)) + t_cr
    pr2 = _matmul_unrolled(p_robot, pose[:3, :3].transpose(-1, -2)) + pose[:3, 3]
    q = _matmul_unrolled(pr2 - t_cr, r_cr)
    x, y, z = q[..., 0], q[..., 1], q[..., 2]
    z_inv = 1.0 / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    col = round_half_away(x * fx * z_inv + ox).to(torch.int32)
    row = round_half_away(y * fy * z_inv + oy).to(torch.int32)
    visible = valid & (row >= 0) & (row < h) & (col >= 0) & (col < w) & (z > 1e-6)
    gray2, depth2, ggx, ggy, dgx, dgy = _exact_gather(planes, torch.clamp(row, 0, h - 1), torch.clamp(col, 0, w - 1))

    # d pixel / d q, then through R_cr^-1 and [I | -skew(pr2)] to the twist
    zero = torch.zeros_like(z)
    j_u = torch.stack([fx * z_inv, zero, -fx * x * z_inv * z_inv], dim=-1)
    j_v = torch.stack([zero, fy * z_inv, -fy * y * z_inv * z_inv], dim=-1)

    def twist(j3):
        j = _matmul_unrolled(j3, r_cr.transpose(-1, -2))
        jw = torch.stack([pr2[..., 1] * j[..., 2] - pr2[..., 2] * j[..., 1],
                          pr2[..., 2] * j[..., 0] - pr2[..., 0] * j[..., 2],
                          pr2[..., 0] * j[..., 1] - pr2[..., 1] * j[..., 0]], dim=-1)
        return torch.cat([j, jw], dim=-1)

    tj_u, tj_v = twist(j_u), twist(j_v)
    # rows [J | r | r] of each term (the program's layout: H, g and the sum
    # of squares from one product)
    rows = torch.empty((gray_src.shape[0], 2, h * w, 8), dtype=torch.float32, device=xyz.device)
    diff = gray2 - gray_src
    wgt = _huber_weight(diff, STD_DEV_PHOTO) * (1.0 / STD_DEV_PHOTO)
    jac = wgt[..., None] * (ggx[..., None] * tj_u + ggy[..., None] * tj_v)
    res = torch.where(visible, wgt * diff, torch.zeros_like(diff))
    rows[:, 0, :, :6] = torch.where(visible[..., None], jac, torch.zeros((), device=jac.device))
    rows[:, 0, :, 6] = res
    rows[:, 0, :, 7] = res
    n_photo = visible.sum(dtype=torch.int32)

    depth_ok = visible & torch.isfinite(depth2) & (depth2 > 0)
    ddiff = depth2 - z
    reg = STD_DEV_DEPTH * torch.clamp(z, min=1e-20)
    wgt = _huber_weight(ddiff, reg) / reg
    j_z = twist(torch.stack([zero, zero, torch.ones_like(z)], dim=-1))
    jac = wgt[..., None] * (dgx[..., None] * tj_u + dgy[..., None] * tj_v - j_z)
    res = torch.where(depth_ok, wgt * ddiff, torch.zeros_like(ddiff))
    rows[:, 1, :, :6] = torch.where(depth_ok[..., None], jac, torch.zeros((), device=jac.device))
    rows[:, 1, :, 6] = res
    rows[:, 1, :, 7] = res
    n_depth = depth_ok.sum(dtype=torch.int32)

    c = rows.shape[0]
    ar = rows.reshape(c * 2 * h, w, 8)
    gram = (ar.transpose(-1, -2) @ ar).reshape(c, 2, h, 8, 8).sum(dim=2).sum(dim=0)
    H = gram[0, :6, :6] + gram[1, :6, :6]
    g = gram[0, :6, 6] + gram[1, :6, 6]
    photo_err2, depth_err2 = gram[0, 7, 7], gram[1, 7, 7]
    return photo_err2 + depth_err2, n_photo + n_depth, H, g, photo_err2, n_photo, depth_err2, n_depth


def _norm6(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0] * x[..., 0]
    for k in range(1, 6):
        s = s + x[..., k] * x[..., k]
    return torch.sqrt(s)


def align_level(level, k, lvl: int, pose0, cam_rts, max_iters: int = MAX_ITERS):
    """One level's damped Gauss-Newton loop with the Levenberg-Marquardt
    retry (RegisterRGBD360.h:423-501). Returns (pose, state, iterations,
    ill_posed)."""
    f32 = np.float32
    c = level.gray_src.shape[0]
    shape = tuple(level.gray_src.shape[-2:])
    xyz, valid = pinhole_lut(level.depth_src, k, lvl)
    gray_src = level.gray_src.reshape(c, -1)
    planes = pack_target_planes8(level)
    eye6 = torch.eye(6, dtype=torch.float32, device=pose0.device)

    def at(pose):
        return sweep(gray_src, planes, shape, xyz, valid, pose, k, lvl, cam_rts)

    def try_step(state, pose, ok, damp):
        H, g = state[2], state[3]
        x, solve_ok = linalg6.solve6_sym(H + damp * (eye6 * H) + (0.0 if ok else 1.0) * eye6, g)
        update = -x
        new_pose = _matmul_unrolled(se3.exp_se3(update[None], pseudo=False)[0], pose)
        new_state = at(new_pose)
        dstep = f32((state[0] - new_state[0]).item())
        return new_pose, new_state, dstep, f32(_norm6(update).item()), bool(solve_ok)

    state = at(pose0)
    pose = pose0
    diff = f32(state[0].item()) + f32(1.0)
    upd = f32(math.sqrt(6.0))
    lam = f32(LM_LAMBDA0)
    it, ill = 0, False
    while it < max_iters and upd > f32(TOL_UPDATE) and diff > f32(TOL_RESIDUAL) and not ill:
        ok = bool(linalg6.spd_well_posed(state[2], float(lam)))
        new_pose, new_state, dstep, norm, solve_ok = try_step(state, pose, ok, float(lam))
        if ok and dstep <= 0:
            damp = max(lam, f32(LM_LAMBDA0)) * f32(LM_STEP)
            new_pose, new_state, dstep, norm, solve_ok = try_step(state, pose, ok, float(damp))
        ok = ok and solve_ok
        accept = ok and dstep > 0
        if accept:
            pose, state = new_pose, new_state
        lam = lam / f32(LM_STEP) if accept else lam * f32(LM_STEP)
        it += int(accept)
        diff = dstep if ok else f32(0.0)
        upd = norm if ok else f32(0.0)
        ill = ill or not ok
    return pose, state, it, ill


def register(gray_src, depth_src, gray_trg, depth_trg, cam_rts, k, guess, n_levels: int = N_LEVELS) -> dict:
    """RegisterDensePhotoICP (PHOTO_DEPTH) of one pair: images (C, H, W) f32
    (depth in metres) on one device, cam_rts (C, 4, 4), k (3, 3) and the
    guess (4, 4) on it or numpy. Returns numpy: pose (4, 4), hessian (6, 6),
    error, av_photo, av_depth, iters (n_levels,), ill."""
    dev = gray_src.device
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32) if isinstance(a, np.ndarray) else a,
                                     dtype=torch.float32, device=dev)
    cam_rts, k, pose = as_t(cam_rts), as_t(k), as_t(guess)
    src = build_pyramid_set(gray_src, depth_src, n_levels, is_target=False, sphere_seam_mask=False)
    trg = build_pyramid_set(gray_trg, depth_trg, n_levels, is_target=True, sphere_seam_mask=False)
    iters, ill_any, state = [], False, None
    for lvl in range(n_levels - 1, -1, -1):
        pose_new, state, it, ill = align_level(make_level_data(src, trg, lvl), k, lvl, pose, cam_rts)
        if not ill_any:
            pose = pose_new
        ill_any = ill_any or ill
        iters.append(it)
    err2, n, H, _g, pe2, n_photo, de2, n_depth = state
    mean = lambda s, m: float(torch.sqrt(s / torch.clamp(m, min=1).to(torch.float32)))
    return {"pose": pose.cpu().numpy(), "hessian": H.cpu().numpy(), "error": mean(err2, n),
            "av_photo": mean(pe2, n_photo), "av_depth": mean(de2, n_depth),
            "iters": np.array(iters, np.int32), "ill": ill_any}
