"""Pinhole dense photo+depth alignment: single-camera (alignFrames) and the
8-camera robot-frame variant behind RegisterDensePhotoICP.

Counterpart of rgbd360_tpu/ops/photoicp_pinhole.py (reference
include/RegisterPhotoICP.h:560-1100 errorPhotoICP / calcHessGrad, :4254-4512
alignFrames, :4905-5270 the robot-frame error and Hessian;
include/RegisterRGBD360.h:344-516 RegisterDensePhotoICP). The JAX package
vmaps its sweep over the cameras; here the cameras are the leading axis C of
every tensor of a sweep ((C, H, W) images, (C, N, 3) points, (C, 4, 4)
extrinsics) and the per-camera sums are summed over it
(photoicp_pinhole.py:300). One robot (or camera) pose is shared by all C.

Semantics carried over (photoicp_pinhole.py:4-33, :140-175, :204-209):
  * nearest-pixel warp u = fx x'/z' + ox with C's round() (round_half_away);
  * the deliberate deviations: the behind-camera guard z > 1e-6, the
    consistent robot depth pair (residual depth2 - z', Jacobian
    grad.Jwarp - J_z), Occ2's depth2 - z with PINHOLE_THRES_DEPTH_OUTLIERS,
    and the z-buffer as a scatter-max in which ties all survive;
  * saliency gates only the single-camera H/g (in PHOTO_DEPTH a pixel must
    pass both tests); the error terms are ungated, and the robot-frame
    variant gates nothing;
  * the level loop: undamped Gauss-Newton for one camera, lambda-damped for
    several, one Levenberg-Marquardt retry of a rejected first step, the full
    SE(3) exponential, and an ill-posed level freezing every finer level's
    pose.

The ``lax.while_loop`` of a level is a host loop with one device sync per
iteration (two when a step is retried, which also costs a second sweep):
the loop's scalars (step error, update norm, lambda) are read as f32 and
updated in f32 on the host, as the JAX carry is.

Not ported (ROADMAP's do-not-port list): ``pack_target_channels`` /
``_gather_rows`` and the f16 gradient packing (photoicp_pinhole.py:151-155).
The target is gathered from the f32 planes of ``pack_target_planes8`` by an
exact index (photoicp._exact_gather), so the gradients stay f32. The jit
entries become ``register_dense_photoicp`` and ``align_frames``. The sweep
is plain torch ops on the tensors' device: the JAX package has no Pallas
kernel on this path.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rgbd360_torch.ops import linalg6, se3
from rgbd360_torch.ops.image import round_half_away
from rgbd360_torch.ops.photoicp import (
    DEPTH_CONSISTENCY,
    LevelData,
    PHOTO_CONSISTENCY,
    PHOTO_DEPTH,
    STD_DEV_DEPTH,
    STD_DEV_PHOTO,
    THRES_SALIENCY,
    MAX_DEPTH,
    MIN_DEPTH,
    _exact_gather,
    _huber_weight,
    _normal_equations,
    build_pyramid_set,
    make_level_data,
    pack_target_planes8,
)
from rgbd360_torch.utils import timing

PINHOLE_THRES_DEPTH_OUTLIERS = 1.0  # reference RegisterPhotoICP.h:215, :4258-4259 (photoicp_pinhole.py:257)

# Sweeps since the last reset_sweep_counts(): "sweeps" every fused sweep of
# a level loop, "lm_retries" the Levenberg-Marquardt retries among them
# (each costs one extra sweep).
SWEEPS = timing.counter_group("photoicp_pinhole.SWEEPS", {"sweeps": 0, "lm_retries": 0})


def reset_sweep_counts() -> None:
    timing.reset_counts(SWEEPS)


def _k_level(k_full: torch.Tensor, level: int):
    s = 1.0 / (2**level)
    return k_full[0, 0] * s, k_full[1, 1] * s, k_full[0, 2] * s, k_full[1, 2] * s


def pinhole_lut(depth: torch.Tensor, k_full: torch.Tensor, level: int):
    """Backprojection LUT of (..., H, W) depth at one pyramid level
    (photoicp_pinhole.py:71; reference :4272-4299). Returns xyz
    (..., H*W, 3) with invalid points zeroed and valid (..., H*W) bool."""
    h, w = depth.shape[-2], depth.shape[-1]
    fx, fy, ox, oy = _k_level(k_full, level)
    cc = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    rr = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    z = depth
    valid = (z > MIN_DEPTH) & (z < MAX_DEPTH)
    x = (cc - ox) * z / fx
    y = (rr - oy) * z / fy
    lead = depth.shape[:-2]
    xyz = torch.stack([x, y, z], dim=-1).reshape(lead + (h * w, 3))
    valid = valid.reshape(lead + (h * w,))
    return torch.where(valid[..., None], xyz, torch.zeros_like(xyz)), valid


def fused_sweep_pinhole(
    gray_src_flat: torch.Tensor,  # (C, N) f32
    planes: torch.Tensor,  # (C, H, 8, W) f32 (pack_target_planes8)
    shape: Tuple[int, int],
    xyz: torch.Tensor,  # (C, N, 3)
    valid: torch.Tensor,  # (C, N) bool
    pose: torch.Tensor,  # (4, 4): the robot pose (the camera pose when cam_rt is None)
    k_full: torch.Tensor,  # (3, 3)
    level: int,
    method: int,
    cam_rt: Optional[torch.Tensor] = None,  # (C, 4, 4) robot-from-camera, or None
    occlusion: int = 0,
):
    """One fused pass over C cameras: error + H + g at ``pose``, summed over
    the cameras (photoicp_pinhole.py:92). Returns 0-dim tensors and H (6, 6),
    g (6,): (err2_sum, n_terms, H, g, photo_err2, n_photo, depth_err2,
    n_depth).

    occlusion: 1 = z-buffered closest-wins per camera (_Occ1), 2 =
    additionally reject points whose depth residual exceeds
    PINHOLE_THRES_DEPTH_OUTLIERS (_Occ2), with the plain pinhole error
    semantics over the visible set (photoicp_pinhole.py:108-116)."""
    h, w = shape
    ncam = xyz.shape[0]
    fx, fy, ox, oy = _k_level(k_full, level)

    if cam_rt is None:
        q = xyz @ pose[:3, :3].T + pose[:3, 3]  # camera-frame warped points
        pr2 = q  # the Jacobian's anchor point
        r_basis = None  # the identity
    else:
        # robot frame: p_robot' = pose @ (cam_rt @ p_cam); q = cam_rt^-1 p_robot'
        r_cr = cam_rt[:, :3, :3]
        t_cr = cam_rt[:, None, :3, 3]
        p_robot = xyz @ r_cr.transpose(-1, -2) + t_cr
        pr2 = p_robot @ pose[:3, :3].T + pose[:3, 3]
        q = (pr2 - t_cr) @ r_cr  # rows: R_cr^-1 (pr2 - t_cr), R_cr orthonormal
        r_basis = r_cr.transpose(-1, -2)  # row chain: j3 @ R_cr^-1

    z = q[..., 2]
    z_inv = 1.0 / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    u = q[..., 0] * fx * z_inv + ox
    v = q[..., 1] * fy * z_inv + oy
    c_int = round_half_away(u).to(torch.int32)
    r_int = round_half_away(v).to(torch.int32)
    # the behind-camera guard z > 1e-6: a deliberate deviation of the JAX
    # package (photoicp_pinhole.py:140-147)
    inb = (r_int >= 0) & (r_int < h) & (c_int >= 0) & (c_int < w) & (z > 1e-6)
    visible = valid & inb
    rc = torch.clamp(r_int, 0, h - 1)
    cc = torch.clamp(c_int, 0, w - 1)
    gray2, depth2, ggx, ggy, dgx, dgy = _exact_gather(planes, rc, cc)

    if occlusion:
        flat = (rc * w + cc).long()
        if occlusion >= 2:
            # dynamic-occlusion rejection before the z-buffer write, with the
            # intended depth2 - z (photoicp_pinhole.py:158-169)
            dynamic = visible & (torch.abs(depth2 - z) > PINHOLE_THRES_DEPTH_OUTLIERS) & (depth2 > 0)
            visible = visible & ~dynamic
        # z-buffer per camera: the closest source point per target pixel
        # survives, ties all survive (photoicp_pinhole.py:170-175)
        z_inv_pos = torch.where(visible, 1.0 / torch.clamp(z, min=1e-12), torch.zeros_like(z))
        zbuf = torch.zeros((ncam, h * w), dtype=z.dtype, device=z.device)
        zbuf = zbuf.scatter_reduce(1, flat, z_inv_pos, reduce="amax", include_self=True)
        visible = visible & (z_inv_pos >= torch.gather(zbuf, 1, flat))

    # pinhole projection Jacobian rows (d u/d q, d v/d q), reference :5167-5177
    zero = torch.zeros_like(z)
    j_u = torch.stack([fx * z_inv, zero, -fx * q[..., 0] * z_inv * z_inv], dim=-1)
    j_v = torch.stack([zero, fy * z_inv, -fy * q[..., 1] * z_inv * z_inv], dim=-1)

    def chain(j3):
        """(C, N, 3) camera-frame row gradient -> (C, N, 6) twist Jacobian:
        j3 @ R_cr^-1 @ [I | -skew(pr2)] (reference :5160-5165)."""
        j3r = j3 if r_basis is None else j3 @ r_basis
        jw = torch.stack(
            [
                pr2[..., 1] * j3r[..., 2] - pr2[..., 2] * j3r[..., 1],
                pr2[..., 2] * j3r[..., 0] - pr2[..., 0] * j3r[..., 2],
                pr2[..., 0] * j3r[..., 1] - pr2[..., 1] * j3r[..., 0],
            ],
            dim=-1,
        )
        return torch.cat([j3r, jw], dim=-1)

    dev = xyz.device
    H = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    g = torch.zeros((6,), dtype=torch.float32, device=dev)
    photo_err2 = depth_err2 = torch.zeros((), dtype=torch.float32, device=dev)
    n_photo = n_depth = torch.zeros((), dtype=torch.int32, device=dev)

    def normal_equations(jac, res):
        H_c, g_c = _normal_equations(jac, res, shape)
        return H_c.sum(dim=0), g_c.sum(dim=0)

    # saliency gates the single-camera H/g only (photoicp_pinhole.py:204-220)
    if cam_rt is None:
        photo_sal = (torch.abs(ggx) >= THRES_SALIENCY) | (torch.abs(ggy) >= THRES_SALIENCY)
        depth_sal = (torch.abs(dgx) >= THRES_SALIENCY) | (torch.abs(dgy) >= THRES_SALIENCY)
        if method == PHOTO_DEPTH:
            hg_ok = visible & photo_sal & depth_sal
        elif method == PHOTO_CONSISTENCY:
            hg_ok = visible & photo_sal
        else:
            hg_ok = visible & depth_sal
    else:
        hg_ok = visible

    if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH):
        diff = gray2 - gray_src_flat
        wgt = _huber_weight(diff, STD_DEV_PHOTO) * (1.0 / STD_DEV_PHOTO)
        res = torch.where(visible, wgt * diff, torch.zeros_like(diff))
        jac = wgt[..., None] * (ggx[..., None] * chain(j_u) + ggy[..., None] * chain(j_v))
        jac = torch.where(hg_ok[..., None], jac, torch.zeros_like(jac))
        H_p, g_p = normal_equations(jac, torch.where(hg_ok, res, torch.zeros_like(res)))
        H, g = H + H_p, g + g_p
        photo_err2 = torch.sum(res * res)
        n_photo = visible.sum(dtype=torch.int32)
    if method in (DEPTH_CONSISTENCY, PHOTO_DEPTH):
        depth_ok = visible & torch.isfinite(depth2) & (depth2 > 0)
        ddiff = depth2 - z
        reg = STD_DEV_DEPTH * torch.clamp(z, min=1e-20)
        wgt = _huber_weight(ddiff, reg) / reg
        res = torch.where(depth_ok, wgt * ddiff, torch.zeros_like(ddiff))
        j_z = chain(torch.tensor([0.0, 0.0, 1.0], device=dev).expand(q.shape))  # d z / d twist
        jac = wgt[..., None] * (dgx[..., None] * chain(j_u) + dgy[..., None] * chain(j_v) - j_z)
        hg_depth = depth_ok & hg_ok
        jac = torch.where(hg_depth[..., None], jac, torch.zeros_like(jac))
        H_d, g_d = normal_equations(jac, torch.where(hg_depth, res, torch.zeros_like(res)))
        H, g = H + H_d, g + g_d
        depth_err2 = torch.sum(res * res)
        n_depth = depth_ok.sum(dtype=torch.int32)

    err2 = photo_err2 + depth_err2
    return err2, n_photo + n_depth, H, g, photo_err2, n_photo, depth_err2, n_depth


class PinholeAlignResult(NamedTuple):
    """photoicp_pinhole.py:260; tensors on the inputs' device."""

    pose: torch.Tensor  # (4, 4)
    hessian: torch.Tensor  # (6, 6) at the final accepted pose, finest level
    gradient: torch.Tensor  # (6,)
    error: torch.Tensor  # () sqrt(err2 / n) at the finest level
    av_photo_residual: torch.Tensor
    av_depth_residual: torch.Tensor
    num_iterations: torch.Tensor  # (n_levels,) i32, coarse -> fine
    ill_posed: torch.Tensor  # () bool


def _align_level_pinhole(level: LevelData, k_full, lvl_idx: int, pose0, method: int, *, max_iters: int,
                         tol_update: float, tol_residual: float, lm_lambda0: float, lm_step: float,
                         cam_rts=None, occlusion: int = 0):
    """One level of the shared GN + LM loop (photoicp_pinhole.py:271) over
    the C cameras of ``level`` ((C, H, W) fields). Returns (pose, state,
    iterations, ill_posed), the last two on the host."""
    shape = tuple(level.gray_src.shape[-2:])
    num_cams = level.gray_src.shape[0]
    xyz, valid = pinhole_lut(level.depth_src, k_full, lvl_idx)
    gray_src_flat = level.gray_src.reshape(num_cams, -1)
    planes = pack_target_planes8(level)
    eye6 = torch.eye(6, dtype=torch.float32, device=pose0.device)
    f32 = np.float32

    def sweep(pose):
        timing.count(SWEEPS, "sweeps")
        return fused_sweep_pinhole(gray_src_flat, planes, shape, xyz, valid, pose, k_full, lvl_idx, method,
                                   cam_rts, occlusion)

    def error_of(state):
        # one camera: ~avResidual scale (reference errorPhotoICP :759-762);
        # several: the raw sum of squares (calcPhotoICPError_robot)
        if num_cams == 1:
            return torch.sqrt(state[0] / torch.clamp(state[1], min=1).to(torch.float32))
        return state[0]

    # the main solve is plain Gauss-Newton for one camera (reference
    # RegisterPhotoICP.h:4693) and lambda-damped for several
    # (RegisterRGBD360.h:423-501); a rejected first step gets one retry at
    # raised damping (photoicp_pinhole.py:315-350)
    always_damped = num_cams > 1

    def try_step(state, pose, H, g, ok, damp):
        """(new_pose, new_state, host f32 [dstep, |update|, solve ok, ok]):
        the iteration's one read-back."""
        x, sok = linalg6.solve6_sym(H + damp * (eye6 * H) + (~ok).to(H.dtype) * eye6, g)
        update = -x
        new_pose = se3.exp_se3(update, pseudo=False) @ pose
        new_state = sweep(new_pose)
        dstep = error_of(state) - error_of(new_state)
        flags = torch.stack([sok, ok]).to(torch.float32)
        host = torch.cat([torch.stack([dstep, torch.linalg.vector_norm(update)]), flags]).cpu().numpy()
        return new_pose, new_state, host

    state = sweep(pose0)
    pose = pose0
    diff = f32(error_of(state).item()) + f32(1.0)
    upd = f32(math.sqrt(6.0))
    it = 0
    lam = f32(lm_lambda0)
    ill = False
    while it < max_iters and upd > f32(tol_update) and diff > f32(tol_residual) and not ill:
        H, g = state[2], state[3]
        ok_t = linalg6.spd_well_posed(H, float(lam))
        new_pose, new_state, host = try_step(state, pose, H, g, ok_t, float(lam) if always_damped else 0.0)
        ok = bool(host[3])
        if ok and host[0] <= 0:
            timing.count(SWEEPS, "lm_retries")
            damp = max(lam, f32(lm_lambda0)) * f32(lm_step)
            new_pose, new_state, host = try_step(state, pose, H, g, ok_t, float(damp))
        dstep, norm, sok = host[0], host[1], host[2]
        ok = ok and bool(sok)
        accept = ok and dstep > 0
        if accept:
            pose, state = new_pose, new_state
        lam = lam / f32(lm_step) if accept else lam * f32(lm_step)
        it += int(accept)
        diff = dstep if ok else f32(0.0)
        upd = norm if ok else f32(0.0)
        ill = ill or not ok
    return pose, state, it, ill


def align_frames_pinhole(
    src_pyrs,
    trg_pyrs,
    k_full: torch.Tensor,
    pose_guess: torch.Tensor,
    method: int = PHOTO_DEPTH,
    cam_rts: Optional[torch.Tensor] = None,
    n_levels: int = 4,
    max_iters: int = 10,
    occlusion: int = 0,
) -> PinholeAlignResult:
    """alignFrames (reference :4254, cam_rts None) or the
    RegisterDensePhotoICP level loop (RegisterRGBD360.h:383-506, cam_rts =
    the C extrinsics) (photoicp_pinhole.py:367). Pyramid levels are
    (C, H, W), C = 1 for one camera."""
    pose = pose_guess.to(torch.float32)
    single = cam_rts is None
    iters = []
    ill_any = False
    last = None
    for lvl in range(n_levels - 1, -1, -1):
        level = make_level_data(src_pyrs, trg_pyrs, lvl)
        pose_new, state, it, ill = _align_level_pinhole(
            level, k_full, lvl, pose, method, max_iters=max_iters,
            tol_update=1e-4 if single else 1e-6, tol_residual=1e-4 if single else 1e-1,
            lm_lambda0=0.01 if single else 0.001, lm_step=10.0, cam_rts=cam_rts, occlusion=occlusion,
        )
        # an ill-posed level freezes the pose of every finer level (:395)
        if not ill_any:
            pose = pose_new
        ill_any = ill_any or ill
        iters.append(it)
        last = state
    err2, n, H, g, pe2, nph, de2, nd = last
    mean = lambda s, k: torch.sqrt(s / torch.clamp(k, min=1).to(torch.float32))
    dev = pose.device
    return PinholeAlignResult(
        pose=pose, hessian=H, gradient=g, error=mean(err2, n),
        av_photo_residual=mean(pe2, nph), av_depth_residual=mean(de2, nd),
        num_iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
        ill_posed=torch.tensor(ill_any, device=dev),
    )


def register_dense_photoicp(
    gray_src: torch.Tensor,  # (C, H, W) f32: the sensors of frame2 (the source)
    depth_src: torch.Tensor,  # (C, H, W) f32 metres
    gray_trg: torch.Tensor,
    depth_trg: torch.Tensor,
    cam_rts: torch.Tensor,  # (C, 4, 4) f32 sensor extrinsics
    k_full: torch.Tensor,  # (3, 3)
    pose_guess: torch.Tensor,  # (4, 4)
    method: int = PHOTO_DEPTH,
    n_levels: int = 4,
) -> PinholeAlignResult:
    """RegisterDensePhotoICP: one robot pose optimized from all C cameras
    (reference RegisterRGBD360.h:344-516; photoicp_pinhole.py:413)."""
    src = build_pyramid_set(gray_src, depth_src, n_levels, is_target=False, sphere_seam_mask=False)
    trg = build_pyramid_set(gray_trg, depth_trg, n_levels, is_target=True, sphere_seam_mask=False)
    return align_frames_pinhole(src, trg, k_full, pose_guess, method, cam_rts=cam_rts, n_levels=n_levels)


def align_frames(
    gray_src: torch.Tensor,  # (H, W) f32
    depth_src: torch.Tensor,  # (H, W) f32 metres
    gray_trg: torch.Tensor,
    depth_trg: torch.Tensor,
    k_full: torch.Tensor,
    pose_guess: torch.Tensor,
    method: int = PHOTO_DEPTH,
    n_levels: int = 4,
    occlusion: int = 0,
) -> PinholeAlignResult:
    """Single-camera pinhole alignFrames (photoicp_pinhole.py:437)."""
    src = build_pyramid_set(gray_src[None], depth_src[None], n_levels, is_target=False, sphere_seam_mask=False)
    trg = build_pyramid_set(gray_trg[None], depth_trg[None], n_levels, is_target=True, sphere_seam_mask=False)
    return align_frames_pinhole(src, trg, k_full, pose_guess, method, None, n_levels, occlusion=occlusion)
