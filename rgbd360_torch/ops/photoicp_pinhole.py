"""Pinhole dense photo+depth alignment: single-camera (alignFrames) and the
8-camera robot-frame variant behind RegisterDensePhotoICP, batched over
pairs.

Counterpart of rgbd360_tpu/ops/photoicp_pinhole.py (reference
include/RegisterPhotoICP.h:560-1100 errorPhotoICP / calcHessGrad, :4254-4512
alignFrames, :4905-5270 the robot-frame error and Hessian;
include/RegisterRGBD360.h:344-516 RegisterDensePhotoICP). The JAX package
vmaps its sweep over the cameras; here every tensor of a sweep carries a
pair axis B and a camera axis C ((B, C, H, W) images, (B, C, N, 3) points,
(C, 4, 4) extrinsics shared by the pairs), and each pair's per-camera sums
are summed over C (photoicp_pinhole.py:300). One robot (or camera) pose per
pair is shared by its C cameras.

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

The ``lax.while_loop`` of a level, vmapped over pairs in the JAX package,
is one host loop over the batch with the semantics of vmap-of-while: each
pair carries its own pose, sweep state, lambda, accepted steps, last error
drop and update norm and ill-posed flag as device tensors (f32, as the JAX
carry), a pair whose loop condition fails keeps them bit for bit, and the
loop runs while any pair is active. Each iteration reads the batch's flags
once: how many pairs take the Levenberg-Marquardt retry (an active,
well-posed pair whose first step raised its error) and whether any pair
stays active. A retry round costs one more batched sweep and one more read.
Each level's first sweep, loop body and retry round are segments
(_LevelLoop): on a CUDA device they replay from CUDA graphs, elsewhere they
run uncaptured, the same kernels bit for bit (ops/level_graphs.py); the
reads are the same on both routes.
No pair's arithmetic depends on another's: every product and reduction has
the same shape whatever B (``_matmul_unrolled``, ``_pair_grams`` and the
per-pair sum over the cameras), so a pair aligned in a batch equals the
pair aligned alone.

Not ported (ROADMAP's do-not-port list): ``pack_target_channels`` /
``_gather_rows`` and the f16 gradient packing (photoicp_pinhole.py:151-155).
The target is gathered from the f32 planes of ``pack_target_planes8`` by an
exact index (photoicp._exact_gather), so the gradients stay f32. The jit
entries become ``register_dense_photoicp`` (batched;
parallel/batch.py::align_batch_rig) and ``align_frames``, and the level's
CUDA graphs take jit's place on the card. The sweep is plain torch ops on
the tensors' device: the JAX package has no Pallas kernel on this path.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional, Tuple

import torch

from rgbd360_torch.ops import level_graphs, linalg6, se3
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
    _matmul_unrolled,
    _pair_grams,
    _select,
    build_pyramid_set,
    make_level_data,
    pack_target_planes8,
)
from rgbd360_torch.utils import timing

PINHOLE_THRES_DEPTH_OUTLIERS = 1.0  # reference RegisterPhotoICP.h:215, :4258-4259 (photoicp_pinhole.py:257)

# Sweeps since the last reset_sweep_counts(): "sweeps" every batched sweep
# of a level loop, "lm_retries" the batched Levenberg-Marquardt retry
# sweeps among them.
SWEEPS = timing.counter_group("photoicp_pinhole.SWEEPS", {"sweeps": 0, "lm_retries": 0})

# The level loop's host side, in the same reset: "iterations" batched loop
# bodies, "syncs" and "wait_ns" the loop's reads of the batch's flags
# (utils/timing.py::host_sync), "host_ns" the wall time inside
# align_frames_pinhole_batch, "pair_retries" the pairs that took the
# Levenberg-Marquardt retry, summed over the retry rounds.
GN = timing.counter_group("photoicp_pinhole.GN",
                          {"iterations": 0, "syncs": 0, "wait_ns": 0, "host_ns": 0, "pair_retries": 0})

# The level loop's CUDA graphs, in the same reset: "captures" the graphs
# captured (three a key), "replays" the first sweeps, loop bodies and retry
# rounds replayed from them, "eager_bodies" the loop bodies run uncaptured
# (every body off a CUDA device; a key's first use; a key beyond the byte
# bound). Replayed bodies are GN's iterations less eager_bodies.
GRAPHS = timing.counter_group("photoicp_pinhole.GRAPHS", {"captures": 0, "replays": 0, "eager_bodies": 0})


def reset_sweep_counts() -> None:
    timing.reset_counts(SWEEPS)
    timing.reset_counts(GN)
    timing.reset_counts(GRAPHS)


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


def _sweep(
    gray_src_flat: torch.Tensor,  # (B, C, N) f32
    planes: torch.Tensor,  # (B*C, H, 8, W) f32 (pack_target_planes8)
    shape: Tuple[int, int],
    xyz: torch.Tensor,  # (B, C, N, 3)
    valid: torch.Tensor,  # (B, C, N) bool
    pose: torch.Tensor,  # (B, 4, 4): the robot poses (the camera poses when cam_rt is None)
    k_full: torch.Tensor,  # (3, 3)
    level: int,
    method: int,
    cam_rt: Optional[torch.Tensor] = None,  # (C, 4, 4) robot-from-camera, or None
    occlusion: int = 0,
):
    """One fused pass over B pairs of C cameras: error + H + g at each
    pair's ``pose``, summed over its cameras (photoicp_pinhole.py:92).
    Returns (err2_sum, n_terms, H, g, photo_err2, n_photo, depth_err2,
    n_depth), each leading with B: H (B, 6, 6), g (B, 6), the rest (B,).

    occlusion: 1 = z-buffered closest-wins per camera (_Occ1), 2 =
    additionally reject points whose depth residual exceeds
    PINHOLE_THRES_DEPTH_OUTLIERS (_Occ2), with the plain pinhole error
    semantics over the visible set (photoicp_pinhole.py:108-116)."""
    h, w = shape
    bsz, ncam = valid.shape[:2]
    fx, fy, ox, oy = _k_level(k_full, level)
    rot = pose[:, None, :3, :3].transpose(-1, -2)  # (B, 1, 3, 3): rows x @ R^T
    trans = pose[:, None, None, :3, 3]

    if cam_rt is None:
        q = _matmul_unrolled(xyz, rot) + trans  # camera-frame warped points
        pr2 = q  # the Jacobian's anchor point
        r_basis = None  # the identity
    else:
        # robot frame: p_robot' = pose @ (cam_rt @ p_cam); q = cam_rt^-1 p_robot'
        r_cr = cam_rt[:, :3, :3]
        t_cr = cam_rt[:, None, :3, 3]
        p_robot = _matmul_unrolled(xyz, r_cr.transpose(-1, -2)) + t_cr
        pr2 = _matmul_unrolled(p_robot, rot) + trans
        q = _matmul_unrolled(pr2 - t_cr, r_cr)  # rows: R_cr^-1 (pr2 - t_cr), R_cr orthonormal
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
    gathered = _exact_gather(planes, rc.reshape(bsz * ncam, -1), cc.reshape(bsz * ncam, -1))
    gray2, depth2, ggx, ggy, dgx, dgy = (x.reshape(bsz, ncam, -1) for x in gathered)

    if occlusion:
        flat = (rc * w + cc).long().reshape(bsz * ncam, -1)
        if occlusion >= 2:
            # dynamic-occlusion rejection before the z-buffer write, with the
            # intended depth2 - z (photoicp_pinhole.py:158-169)
            dynamic = visible & (torch.abs(depth2 - z) > PINHOLE_THRES_DEPTH_OUTLIERS) & (depth2 > 0)
            visible = visible & ~dynamic
        # z-buffer per camera: the closest source point per target pixel
        # survives, ties all survive (photoicp_pinhole.py:170-175)
        z_inv_pos = torch.where(visible, 1.0 / torch.clamp(z, min=1e-12), torch.zeros_like(z)).reshape(bsz * ncam, -1)
        zbuf = torch.zeros((bsz * ncam, h * w), dtype=z.dtype, device=z.device)
        zbuf = zbuf.scatter_reduce(1, flat, z_inv_pos, reduce="amax", include_self=True)
        visible = visible & (z_inv_pos >= torch.gather(zbuf, 1, flat)).reshape(bsz, ncam, -1)

    # pinhole projection Jacobian rows (d u/d q, d v/d q), reference :5167-5177
    zero = torch.zeros_like(z)
    j_u = torch.stack([fx * z_inv, zero, -fx * q[..., 0] * z_inv * z_inv], dim=-1)
    j_v = torch.stack([zero, fy * z_inv, -fy * q[..., 1] * z_inv * z_inv], dim=-1)

    def chain(j3):
        """(B, C, N, 3) camera-frame row gradient -> (B, C, N, 6) twist
        Jacobian: j3 @ R_cr^-1 @ [I | -skew(pr2)] (reference :5160-5165)."""
        j3r = j3 if r_basis is None else _matmul_unrolled(j3, r_basis)
        jw = torch.stack(
            [
                pr2[..., 1] * j3r[..., 2] - pr2[..., 2] * j3r[..., 1],
                pr2[..., 2] * j3r[..., 0] - pr2[..., 0] * j3r[..., 2],
                pr2[..., 0] * j3r[..., 1] - pr2[..., 1] * j3r[..., 0],
            ],
            dim=-1,
        )
        return torch.cat([j3r, jw], dim=-1)

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

    # per camera and term, the rows [J | r gated as H and g | r] reduced by
    # _pair_grams: H, g and the error's sum of squares from one product
    terms = ["photo"] if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH) else []
    if method in (DEPTH_CONSISTENCY, PHOTO_DEPTH):
        terms.append("depth")
    rows = torch.empty((bsz, ncam, len(terms), h * w, 8), dtype=torch.float32, device=xyz.device)
    cj_u, cj_v = chain(j_u), chain(j_v)
    counts = {}
    for k, name in enumerate(terms):
        if name == "photo":
            ok, ok_hg = visible, hg_ok
            diff = gray2 - gray_src_flat
            wgt = _huber_weight(diff, STD_DEV_PHOTO) * (1.0 / STD_DEV_PHOTO)
            jac = wgt[..., None] * (ggx[..., None] * cj_u + ggy[..., None] * cj_v)
        else:
            ok = visible & torch.isfinite(depth2) & (depth2 > 0)
            ok_hg = ok & hg_ok
            diff = depth2 - z
            reg = STD_DEV_DEPTH * torch.clamp(z, min=1e-20)
            wgt = _huber_weight(diff, reg) / reg
            j_z = chain(torch.stack([zero, zero, torch.ones_like(z)], dim=-1))  # d z / d twist
            jac = wgt[..., None] * (dgx[..., None] * cj_u + dgy[..., None] * cj_v - j_z)
        res = torch.where(ok, wgt * diff, torch.zeros_like(diff))
        torch.where(ok_hg[..., None], jac, torch.zeros((), device=jac.device), out=rows[:, :, k, :, :6])
        torch.where(ok_hg, res, torch.zeros((), device=res.device), out=rows[:, :, k, :, 6])
        rows[:, :, k, :, 7] = res
        counts[name] = ok.sum(dim=(1, 2), dtype=torch.int32)
    grams = _pair_grams(rows.reshape(bsz, ncam * len(terms), h * w, 8), shape)
    # then each pair's sum over its cameras, a pair at a time (B-free shapes)
    grams = torch.stack([gp.reshape(ncam, len(terms), 8, 8).sum(dim=0) for gp in grams])

    zero_f = torch.zeros((bsz,), dtype=torch.float32, device=xyz.device)
    zero_i = torch.zeros((bsz,), dtype=torch.int32, device=xyz.device)
    H = torch.zeros((bsz, 6, 6), dtype=torch.float32, device=xyz.device)
    g = torch.zeros((bsz, 6), dtype=torch.float32, device=xyz.device)
    err2 = {"photo": zero_f, "depth": zero_f}
    for k, name in enumerate(terms):
        H, g = H + grams[:, k, :6, :6], g + grams[:, k, :6, 6]
        err2[name] = grams[:, k, 7, 7]
    n_photo, n_depth = counts.get("photo", zero_i), counts.get("depth", zero_i)
    return (err2["photo"] + err2["depth"], n_photo + n_depth, H, g, err2["photo"], n_photo, err2["depth"],
            n_depth)


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
    """_sweep for one pair: 0-dim tensors and H (6, 6), g (6,):
    (err2_sum, n_terms, H, g, photo_err2, n_photo, depth_err2, n_depth)."""
    out = _sweep(gray_src_flat[None], planes, shape, xyz[None], valid[None], pose[None], k_full, level, method,
                 cam_rt, occlusion)
    return tuple(x[0] for x in out)


class PinholeAlignResult(NamedTuple):
    """photoicp_pinhole.py:260; tensors on the inputs' device, each leading
    with the pair axis B from the batched entries (register_dense_photoicp,
    align_frames_pinhole_batch), without it from the one-pair ones."""

    pose: torch.Tensor  # (4, 4)
    hessian: torch.Tensor  # (6, 6) at the final accepted pose, finest level
    gradient: torch.Tensor  # (6,)
    error: torch.Tensor  # () sqrt(err2 / n) at the finest level
    av_photo_residual: torch.Tensor
    av_depth_residual: torch.Tensor
    num_iterations: torch.Tensor  # (n_levels,) i32, coarse -> fine
    ill_posed: torch.Tensor  # () bool


class _Carry(NamedTuple):
    """What each pair carries from one loop body to the next (the JAX
    carry, photoicp_pinhole.py:328)."""

    pose: torch.Tensor  # (B, 4, 4)
    state: tuple  # the sweep's 8 outputs at pose
    lam: torch.Tensor  # (B,) f32
    it: torch.Tensor  # (B,) i32 accepted steps
    diff: torch.Tensor  # (B,) f32 the last step's error drop
    upd: torch.Tensor  # (B,) f32 the last step's update norm
    ill: torch.Tensor  # (B,) bool

    def flat(self) -> list:
        return [self.pose, *self.state, self.lam, self.it, self.diff, self.upd, self.ill]

    @staticmethod
    def unflat(ts) -> "_Carry":
        return _Carry(ts[0], tuple(ts[1:9]), *ts[9:])

    def copy(self) -> "_Carry":
        return _Carry.unflat([t.clone() for t in self.flat()])


class _Step(NamedTuple):
    """One tried step of every pair."""

    pose: torch.Tensor
    state: tuple
    dstep: torch.Tensor  # (B,) error at the carry less error at pose
    update: torch.Tensor  # (B, 6)
    solve_ok: torch.Tensor  # (B,) bool


class _LoopSpec(NamedTuple):
    """What one level's loop runs with; with the device and B, the key of
    its CUDA graphs."""

    shape: Tuple[int, int]
    ncam: int
    level: int  # the pyramid level: the camera matrix's scale
    method: int
    occlusion: int
    max_iters: int
    tol_update: float
    tol_residual: float
    lm_lambda0: float
    lm_step: float
    dtypes: tuple  # of the level's 8 images, k_full and cam_rts (None: one camera's frame)


def _norm6(x: torch.Tensor) -> torch.Tensor:
    """|x| over the last axis of (..., 6), summed in order (the same bits
    whatever the leading shape)."""
    s = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k] * x[..., k]
    return torch.sqrt(s)


def _flags(retry: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The batch's flags on the device: (pairs to retry, pairs active)."""
    return torch.stack([retry.sum(), active.sum()])


def _read_flags(flags: torch.Tensor):
    """The loop's one read of the batch: (pairs to retry, any pair active)."""
    n_retry, n_active = flags.tolist()
    return n_retry, n_active > 0


class _LevelLoop:
    """One level's loop for B pairs of C cameras: the arithmetic (the sweep
    at a pose, the carry's init, step, accept and retry), the loop's three
    segments and ``run``, which runs them captured or not
    (ops/level_graphs.py):
      first sweep:  the backprojection LUT, the sweep at pose0, the carry
      loop body:    a copy of the carry, the first step and its sweep, accept,
                    the flags (pairs to retry, pairs active)
      retry round:  the second step from the copy, the per-pair select,
                    accept, any pair active
    The carry lives in the key's buffers and is updated in place; the host
    reads the flags once per body and once more per retry round."""

    def __init__(self, spec: _LoopSpec, level: LevelData, k_full, cam_rts, segments: level_graphs.Segments):
        dev = level.gray_src.device
        like = lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev)
        h, w = spec.shape
        self.spec, self.segments = spec, segments
        # the level's inputs, copied in by each run
        self.gray_src, self.depth_src = like(level.gray_src), like(level.depth_src)
        self.planes = torch.empty(level.gray_trg.shape[:-2] + (h, 8, w), dtype=level.gray_trg.dtype, device=dev)
        self.pose0 = torch.empty((level.gray_src.shape[0], 4, 4), dtype=torch.float32, device=dev)
        self.k_full = like(k_full)
        self.cam_rts = None if cam_rts is None else like(cam_rts)
        buffers = [t for t in (self.gray_src, self.depth_src, self.planes, self.pose0, self.k_full, self.cam_rts)
                   if t is not None]
        # 0: the first sweep, 1: the loop body, 2: the retry round
        segments.record(self, [[_LevelLoop._first], [_LevelLoop._body], [_LevelLoop._retry]], buffers)

    # the arithmetic
    def sweep(self, pose):
        s = self.spec
        return _sweep(self.gray_src_flat, self.planes_flat, s.shape, self.xyz, self.valid, pose, self.k_full, s.level,
                      s.method, self.cam_rts, s.occlusion)

    def error_of(self, state):
        # one camera: ~avResidual scale (reference errorPhotoICP :759-762);
        # several: the raw sum of squares (calcPhotoICPError_robot)
        if self.spec.ncam == 1:
            return torch.sqrt(state[0] / torch.clamp(state[1], min=1).to(torch.float32))
        return state[0]

    def init(self, pose0) -> _Carry:
        """The carry at pose0, after the level's first sweep."""
        bsz, dev = pose0.shape[0], pose0.device
        state0 = self.sweep(pose0)
        return _Carry(pose0, state0, self.lam0, torch.zeros((bsz,), dtype=torch.int32, device=dev),
                      self.error_of(state0) + 1.0,
                      torch.full((bsz,), math.sqrt(6.0), dtype=torch.float32, device=dev),
                      torch.zeros((bsz,), dtype=torch.bool, device=dev))

    def active_of(self, c: _Carry):
        s = self.spec
        return (c.it < s.max_iters) & (c.upd > s.tol_update) & (c.diff > s.tol_residual) & ~c.ill

    def try_step(self, c: _Carry, ok, damp) -> _Step:
        H, g = c.state[2], c.state[3]
        eye6 = self.eye6
        # the (~ok)*I guard keeps the solve finite on an ill-posed pair
        x, solve_ok = linalg6.solve6_sym(H + damp[:, None, None] * (eye6 * H) + (~ok).to(H.dtype)[:, None, None] * eye6,
                                         g)
        update = -x
        new_pose = _matmul_unrolled(se3.exp_se3(update, pseudo=False), c.pose)
        new_state = self.sweep(new_pose)
        return _Step(new_pose, new_state, self.error_of(c.state) - self.error_of(new_state), update, solve_ok)

    def accept(self, c: _Carry, active, ok, s: _Step) -> _Carry:
        lm_step = self.spec.lm_step
        ok = ok & s.solve_ok
        take = active & ok & (s.dstep > 0)
        zero = torch.zeros_like(s.dstep)
        return _Carry(
            _select(take, s.pose, c.pose),
            tuple(_select(take, n, o) for n, o in zip(s.state, c.state)),
            torch.where(active, torch.where(take, c.lam / lm_step, c.lam * lm_step), c.lam),
            c.it + take.to(torch.int32),
            torch.where(active, torch.where(ok, s.dstep, zero), c.diff),
            torch.where(active, torch.where(ok, _norm6(s.update), zero), c.upd),
            c.ill | (active & ~ok),
        )

    def first_step(self, c: _Carry, active):
        """A loop body's first step: (ok, the step, the pairs to retry, the
        carry after the step). The main solve is plain Gauss-Newton for one
        camera (reference RegisterPhotoICP.h:4693) and lambda-damped for
        several (RegisterRGBD360.h:423-501)."""
        ok = linalg6.spd_well_posed(c.state[2], c.lam[:, None, None])
        first = self.try_step(c, ok, c.lam if self.spec.ncam > 1 else torch.zeros_like(c.lam))
        retry = active & ok & (first.dstep <= 0)
        return ok, first, retry, self.accept(c, active, ok, first)

    def retry_step(self, c: _Carry, active, ok, first: _Step, retry) -> _Carry:
        """The carry after the body when the pairs ``retry`` retry their
        rejected first step at raised damping (photoicp_pinhole.py:315-350),
        from the carry ``c`` as it stood before the body."""
        second = self.try_step(c, ok, torch.maximum(c.lam, self.lam0) * self.spec.lm_step)
        step = _Step(
            _select(retry, second.pose, first.pose),
            tuple(_select(retry, s, f) for s, f in zip(second.state, first.state)),
            *(_select(retry, s, f) for s, f in zip(second[2:], first[2:])),
        )
        return self.accept(c, active, ok, step)

    # the segments; what they leave on self is, captured, the graphs' own
    # memory, rewritten by each replay. They count nothing: run() counts on
    # the host.
    def _first(self):
        s = self.spec
        bsz, dev = self.pose0.shape[0], self.pose0.device
        self.xyz, self.valid = pinhole_lut(self.depth_src, self.k_full, s.level)
        self.gray_src_flat = self.gray_src.reshape(bsz, s.ncam, -1)
        self.planes_flat = self.planes.reshape((-1,) + self.planes.shape[2:])  # (B*C, H, 8, W)
        self.eye6 = torch.eye(6, dtype=torch.float32, device=dev)
        self.lam0 = torch.full((bsz,), s.lm_lambda0, dtype=torch.float32, device=dev)
        self.carry = self.init(self.pose0).copy()
        self.active = self.active_of(self.carry)

    def _body(self):
        # the carry as it stood before the body, where a retry round starts
        self.prev, self.prev_active = self.carry.copy(), self.active.clone()
        self.ok, self.step, self.retry_mask, nxt = self.first_step(self.prev, self.prev_active)
        self._commit(nxt)
        self.flags = _flags(self.retry_mask, self.active)

    def _retry(self):
        self._commit(self.retry_step(self.prev, self.prev_active, self.ok, self.step, self.retry_mask))
        self.any_active = self.active.any()

    def _commit(self, nxt: _Carry) -> None:
        for dst, src in zip(self.carry.flat(), nxt.flat()):
            dst.copy_(src)
        self.active.copy_(self.active_of(self.carry))

    def _replay(self, k: int) -> None:
        timing.count(SWEEPS, "sweeps")
        self.segments.replay(k, self)
        self.segments.count(body=k == 1)

    def run(self, level: LevelData, k_full, pose0: torch.Tensor, cam_rts) -> _Carry:
        """The level's loop for inputs of the key's shapes. Returns the carry
        as a copy, which the next run does not overwrite."""
        self.gray_src.copy_(level.gray_src)
        self.depth_src.copy_(level.depth_src)
        pack_target_planes8(level, out=self.planes)
        self.pose0.copy_(pose0)
        self.k_full.copy_(k_full)
        if cam_rts is not None:
            self.cam_rts.copy_(cam_rts)
        self._replay(0)
        # every pair with a finite error starts active; a body in which none
        # is active changes nothing, so the first loop test is not read
        more = self.spec.max_iters > 0
        while more:
            timing.count(GN, "iterations")
            with timing.span("rig iteration"):
                self._replay(1)
                n_retry, more = timing.host_sync(_read_flags, self.flags)
                if n_retry:
                    timing.count(SWEEPS, "lm_retries")
                    timing.count(GN, "pair_retries", n_retry)
                    self._replay(2)
                    more = timing.host_sync(bool, self.any_active)
        return self.carry.copy()


# The robot-frame loop's graphs, one byte bound a thread of its own
# (ops/level_graphs.py).
GRAPH_CACHE = level_graphs.GraphCache(GRAPHS)


def _align_level(level: LevelData, k_full, lvl_idx: int, pose0, method: int, *, max_iters: int, tol_update: float,
                 tol_residual: float, lm_lambda0: float, lm_step: float, cam_rts=None, occlusion: int = 0):
    """One level of the shared GN + LM loop (photoicp_pinhole.py:271) for B
    pairs of C cameras ((B, C, H, W) fields of ``level``), vmap-of-while as
    the module's docstring says, through this thread's _LevelLoop of the key
    (GRAPH_CACHE). Returns (pose, state, iterations, ill_posed), each
    leading with B."""
    bsz, ncam = level.gray_src.shape[:2]
    shape = tuple(level.gray_src.shape[-2:])
    dtypes = tuple(t.dtype for t in (*level, k_full)) + (None if cam_rts is None else cam_rts.dtype,)
    spec = _LoopSpec(shape, ncam, lvl_idx, method, occlusion, max_iters, tol_update, tol_residual, lm_lambda0,
                     lm_step, dtypes)
    loop = GRAPH_CACHE.loop(pose0.device, bsz, spec,
                            lambda segments: _LevelLoop(spec, level, k_full, cam_rts, segments))
    c = loop.run(level, k_full, pose0, cam_rts)
    return c.pose, c.state, c.it, c.ill


def align_frames_pinhole_batch(
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
    the C extrinsics) (photoicp_pinhole.py:367) for B pairs. Pyramid levels
    are (B, C, H, W), C = 1 for one camera; pose_guess (B, 4, 4).

    Counted in GN; traced as the spans "rig align" > "rig level" > "rig
    iteration", with "GN sync" around each read of the batch's flags."""
    t_enter = time.perf_counter_ns()
    pose = pose_guess.to(torch.float32)
    bsz = pose.shape[0]
    single = cam_rts is None
    ill_any = torch.zeros((bsz,), dtype=torch.bool, device=pose.device)
    iters = []
    last = None
    with timing.span("rig align", B=bsz, levels=n_levels), timing.sync_scope(GN, "GN sync"):
        for lvl in range(n_levels - 1, -1, -1):
            level = make_level_data(src_pyrs, trg_pyrs, lvl)
            with timing.span("rig level", level=lvl):
                pose_new, state, it, ill = _align_level(
                    level, k_full, lvl, pose, method, max_iters=max_iters,
                    tol_update=1e-4 if single else 1e-6, tol_residual=1e-4 if single else 1e-1,
                    lm_lambda0=0.01 if single else 0.001, lm_step=10.0, cam_rts=cam_rts, occlusion=occlusion,
                )
            # an ill-posed level freezes the pose of every finer level (:395)
            pose = _select(ill_any, pose, pose_new)
            ill_any = ill_any | ill
            iters.append(it)
            last = state
    err2, n, H, g, pe2, nph, de2, nd = last
    mean = lambda s, k: torch.sqrt(s / torch.clamp(k, min=1).to(torch.float32))
    result = PinholeAlignResult(
        pose=pose, hessian=H, gradient=g, error=mean(err2, n),
        av_photo_residual=mean(pe2, nph), av_depth_residual=mean(de2, nd),
        num_iterations=torch.stack(iters, dim=1), ill_posed=ill_any,
    )
    timing.count(GN, "host_ns", time.perf_counter_ns() - t_enter)
    return result


def _one_pair(pyrs):
    return tuple([lv[None] for lv in part] for part in pyrs)


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
    """align_frames_pinhole_batch for one pair: pyramid levels (C, H, W),
    pose_guess (4, 4); the result without the pair axis."""
    res = align_frames_pinhole_batch(_one_pair(src_pyrs), _one_pair(trg_pyrs), k_full, pose_guess[None], method,
                                     cam_rts, n_levels, max_iters, occlusion)
    return PinholeAlignResult(*(x[0] for x in res))


def register_dense_photoicp(
    gray_src: torch.Tensor,  # (B, C, H, W) f32: the sensors of each pair's source frame
    depth_src: torch.Tensor,  # (B, C, H, W) f32 metres
    gray_trg: torch.Tensor,
    depth_trg: torch.Tensor,
    cam_rts: torch.Tensor,  # (C, 4, 4) f32 sensor extrinsics
    k_full: torch.Tensor,  # (3, 3)
    pose_guess: torch.Tensor,  # (B, 4, 4)
    method: int = PHOTO_DEPTH,
    n_levels: int = 4,
) -> PinholeAlignResult:
    """RegisterDensePhotoICP for B pairs: per pair one robot pose optimized
    from all C cameras (reference RegisterRGBD360.h:344-516;
    photoicp_pinhole.py:413). Every field of the result leads with B."""
    src = build_pyramid_set(gray_src, depth_src, n_levels, is_target=False, sphere_seam_mask=False)
    trg = build_pyramid_set(gray_trg, depth_trg, n_levels, is_target=True, sphere_seam_mask=False)
    return align_frames_pinhole_batch(src, trg, k_full, pose_guess, method, cam_rts=cam_rts, n_levels=n_levels)


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
