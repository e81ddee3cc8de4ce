"""Organized multi-plane segmentation as iterative label propagation.

Counterpart of rgbd360_tpu/ops/planes_seg.py: PCL
OrganizedMultiPlaneSegmentation with the reference's configuration
(include/Frame360.h:958-977: min inliers 80, angular threshold 0.039812 rad,
distance threshold 0.02 m). Two 4-connected pixels belong to the same planar
region when their normals agree within the angular threshold and their plane
offsets (n . p) differ by less than the distance threshold; the labels are
the fixed point of a min-label flood fill (the smallest flat pixel index of
each connected component), then the boundary refinement of PCL's
segmentAndRefine grows the accepted regions.

Each flood-fill round takes the minimum over whole connected row runs, then
over whole connected column runs. JAX computes the run minima with
``lax.associative_scan`` segmented scans; here a run is a segment id
(the cumulative count of run starts) and its minimum one
``scatter_reduce(amin)`` plus a gather. Both are exact minima, so every
round, and the fixed point, is the same. Both ``while_loop``s keep the
``max_sweeps = h*w`` backstop. The flood fill's is a host loop on
``any(changed)``. The refinement's growth loop (``grow_labels``) runs on a
CUDA tensor to its fixed point in one launch of csrc/planes_refine.cu, with
no host read; on the CPU it is the plain host loop ``grow_labels_plain``,
which the kernel equals bit for bit. ``REFINE`` counts both.

The JAX functions take one sensor and are vmapped; these take (S, H, W).
A batch keeps sweeping until every sensor has converged; a sweep of a
converged sensor changes nothing.
"""

from __future__ import annotations

import ctypes

import torch

from rgbd360_torch.ops.normals import dot3
from rgbd360_torch.utils import timing

ANGULAR_THRESHOLD = 0.039812  # rad (~2.3 deg)
DISTANCE_THRESHOLD = 0.02  # m
MIN_INLIERS = 80

# the refinement's growth loop: launches of csrc/planes_refine.cu, calls that
# ran the plain loop and the rounds those ran (counted on the host, with no
# read of the device); reset by the caller that reads them
REFINE = timing.counter_group("planes_seg.REFINE", {"kernel": 0, "host_loop": 0, "host_rounds": 0})


def cos_threshold(angular_threshold: float = ANGULAR_THRESHOLD) -> float:
    """The f32 cosine of the angular threshold, as jnp.cos computes it
    (planes_seg.py:66): the edge predicate compares an f32 dot product
    against it, so an f64 cosine rounded afterwards could sit one ulp off
    right on the predicate. An f32 value, exact as a Python float."""
    return float(torch.cos(torch.tensor(angular_threshold, dtype=torch.float32)))


def _run_ids(start: torch.Tensor) -> torch.Tensor:
    """Flat run ids from (..., L) run-start flags (each row starts a run)."""
    return torch.cumsum(start.reshape(-1).to(torch.int64), 0) - 1


def _run_min(vals: torch.Tensor, ids: torch.Tensor, big: int) -> torch.Tensor:
    """Minimum of ``vals`` over each run, given to every element of it."""
    flat = vals.reshape(-1)
    mins = torch.full_like(flat, big).scatter_reduce(0, ids, flat, reduce="amin", include_self=True)
    return mins[ids].reshape(vals.shape)


def segment_planes(
    xyz: torch.Tensor,  # (S, H, W, 3) NaN-invalid
    normals: torch.Tensor,  # (S, H, W, 3) NaN-invalid
    max_sweeps: int | None = None,
    angular_threshold: float = ANGULAR_THRESHOLD,
    distance_threshold: float = DISTANCE_THRESHOLD,
) -> torch.Tensor:
    """Returns labels (S, H, W) int32: -1 invalid, else the component id
    (the smallest flat pixel index of the component within its sensor)
    (planes_seg.py:33; its ``jumps`` schedule knob, default 0, reaches the
    same fixed point and is not ported)."""
    s, h, w = xyz.shape[:3]
    dev = xyz.device
    if max_sweeps is None:
        max_sweeps = h * w
    valid = torch.isfinite(xyz).all(-1) & torch.isfinite(normals).all(-1)
    zero = torch.zeros((), device=dev)
    n = torch.where(valid[..., None], normals, zero)
    p = torch.where(valid[..., None], xyz, zero)
    d = dot3(n, p)  # plane offset per pixel
    cos_thr = cos_threshold(angular_threshold)

    def connected(a, b):
        dot = dot3(n[a], n[b])
        return valid[a] & valid[b] & (dot > cos_thr) & (torch.abs(d[a] - d[b]) < distance_threshold)

    every = slice(None)
    right = connected((every, every, slice(None, -1)), (every, every, slice(1, None)))  # (S, H, W-1)
    down = connected((every, slice(None, -1)), (every, slice(1, None)))  # (S, H-1, W)

    # run starts: a pixel not connected to its left (upper) neighbour
    row_start = torch.ones((s, h, w), dtype=torch.bool, device=dev)
    row_start[:, :, 1:] = ~right
    col_start = torch.ones((s, w, h), dtype=torch.bool, device=dev)  # column-major
    col_start[:, :, 1:] = ~down.transpose(1, 2)
    row_ids, col_ids = _run_ids(row_start), _run_ids(col_start)

    big = h * w  # sentinel larger than any label
    idx = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(1, h, w)
    labels = torch.where(valid, idx, big)
    for _ in range(max_sweeps):
        new = _run_min(labels, row_ids, big)
        new = _run_min(new.transpose(1, 2).contiguous(), col_ids, big).transpose(1, 2)
        new = torch.where(valid, new, big)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return torch.where(valid, labels, -1).contiguous()


def _shift(arr: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """out[:, i, j] = arr[:, i - dr, j - dc], ``fill`` outside
    (planes_seg.py:272)."""
    h, w = arr.shape[1], arr.shape[2]
    out = torch.full_like(arr, fill)
    out[:, max(dr, 0) : h + min(dr, 0), max(dc, 0) : w + min(dc, 0)] = arr[
        :, max(-dr, 0) : h - max(dr, 0), max(-dc, 0) : w - max(dc, 0)
    ]
    return out


def _bin_sum(bins: torch.Tensor, vals: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(S, N) bins, (S, N, C) values -> (S, n_bins, C) per-bin sums, each
    bin summed in index order, as XLA's CPU scatter. On the CPU that is
    ``index_add_``. On the card ``index_add_`` adds with atomics, whose
    order varies from run to run (measured: the refined labels of one frame
    flapped by 0.17%); ``index_put_(accumulate=True)`` sorts the indices
    stably and adds each bin's values in that order, which on an H100 gave
    the CPU's sums bit for bit, run after run."""
    s, _n, c = vals.shape
    offs = (torch.arange(s, device=bins.device) * n_bins)[:, None]
    idx, flat = (bins + offs).reshape(-1), vals.reshape(-1, c)
    out = torch.zeros((s * n_bins, c), dtype=vals.dtype, device=vals.device)
    if out.device.type == "cuda":
        out.index_put_((idx,), flat, accumulate=True)
    else:
        out.index_add_(0, idx, flat)
    return out.reshape(s, n_bins, c)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(S, T, C) table, (S, N) indices -> (S, N, C)."""
    return torch.gather(table, 1, idx[..., None].expand(-1, -1, table.shape[-1]))


def top_k_stable(vals: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index, as
    ``jax.lax.top_k``: a stable descending sort (``torch.topk`` leaves the
    order of ties unspecified)."""
    v, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _second_moments(dc: torch.Tensor, pk: torch.Tensor, n_bins: int, nb: int, cnts: torch.Tensor) -> torch.Tensor:
    """Centered per-bin covariance (S, nb, 3, 3) from offsets dc (S, N, 3)."""
    prods = torch.stack(
        [dc[..., 0] * dc[..., 0], dc[..., 0] * dc[..., 1], dc[..., 0] * dc[..., 2],
         dc[..., 1] * dc[..., 1], dc[..., 1] * dc[..., 2], dc[..., 2] * dc[..., 2]],
        dim=-1,
    )
    s2 = _bin_sum(pk, prods, n_bins)[:, :nb] / torch.clamp(cnts[..., None], min=1.0)
    return torch.stack(
        [torch.stack([s2[..., 0], s2[..., 1], s2[..., 2]], -1),
         torch.stack([s2[..., 1], s2[..., 3], s2[..., 4]], -1),
         torch.stack([s2[..., 2], s2[..., 4], s2[..., 5]], -1)],
        dim=-2,
    )


def refine_plane_labels(
    labels: torch.Tensor,  # (S, H, W) i32 from segment_planes (-1 unlabeled)
    xyz: torch.Tensor,  # (S, H, W, 3) NaN-invalid
    normals: torch.Tensor = None,  # unused, as in JAX (the models are point fits)
    max_sweeps: int | None = None,
    distance_threshold: float = DISTANCE_THRESHOLD,
    min_inliers: int = MIN_INLIERS,
) -> torch.Tensor:
    """Boundary refinement after the flood fill (planes_seg.py:142; the
    'refine' half of PCL's segmentAndRefine, reference
    include/Frame360.h:977): valid unlabeled pixels are absorbed by an
    adjacent ACCEPTED region (>= min_inliers segment-stage pixels) when
    they fit its segment-stage least-squares plane within
    distance_threshold, to the fixed point; contested pixels take the
    largest label."""
    from rgbd360_torch.ops.plane_stats import _eigh3x3

    s, h, w = labels.shape
    hw = h * w
    dev = labels.device
    if max_sweeps is None:
        max_sweeps = hw
    valid_xyz = torch.isfinite(xyz).all(-1)
    zero = torch.zeros((), device=dev)
    p = torch.where(valid_xyz[..., None], xyz, zero)

    labf = labels.reshape(s, hw)
    lab_ok = labf >= 0
    bin_ = torch.where(lab_ok, labf, hw).to(torch.int64)
    pf = p.reshape(s, hw, 3)
    feat = torch.cat([pf, torch.ones((s, hw, 1), device=dev)], dim=-1)
    sums = _bin_sum(bin_, feat, hw + 1)  # (S, hw+1, 4)
    cnt_all = sums[..., 3]

    # pigeonhole rebin into the top-KP label slots by count when the grid
    # admits it (planes_seg.py:188-228)
    KP = min(hw, hw // max(min_inliers, 1) + 1)
    if KP <= 512:
        topc, topi = top_k_stable(cnt_all[:, :hw], KP)
        inv = torch.full((s, hw + 1), KP, dtype=torch.int64, device=dev)
        inv.scatter_(1, topi, torch.arange(KP, device=dev).expand(s, KP).contiguous())
        pix_k = torch.gather(inv, 1, bin_)
        cnt = topc
        centroid = _gather_rows(sums[..., :3], topi) / torch.clamp(cnt[..., None], min=1.0)
        cpad = torch.cat([centroid, torch.zeros((s, 1, 3), device=dev)], dim=1)
        dvec = pf - _gather_rows(cpad, pix_k)
        dvec = torch.where((lab_ok & (pix_k < KP))[..., None], dvec, zero)
        s2_bins, nb = KP + 1, KP
    else:
        pix_k = bin_
        cnt = cnt_all
        centroid = sums[..., :3] / torch.clamp(cnt[..., None], min=1.0)
        dvec = pf - _gather_rows(centroid, bin_)
        dvec = torch.where(lab_ok[..., None], dvec, zero)
        s2_bins, nb = hw + 1, hw + 1
    cov = _second_moments(dvec, pix_k, s2_bins, nb, cnt[:, :nb])
    _, n_min = _eigh3x3(cov)
    centroid = centroid[:, :nb]
    flip = dot3(n_min, centroid) > 0  # toward the sensor (:988-992)
    n_model = torch.where(flip[..., None], -n_min, n_min)
    d_model = dot3(n_model, centroid)
    is_model = cnt[:, :nb] >= min_inliers

    # each pixel carries its own region's (normal, d); candidates come from
    # 1-pixel shifts of these planes
    own = torch.clamp(pix_k, 0, nb - 1)
    in_tbl = lab_ok & (pix_k < nb)
    grows = (torch.gather(is_model, 1, own) & in_tbl).reshape(s, h, w)
    mod_n = torch.where(in_tbl[..., None], _gather_rows(n_model, own), zero).reshape(s, h, w, 3)
    mod_d = torch.where(in_tbl, torch.gather(d_model, 1, own), zero).reshape(s, h, w)
    lab_grow = torch.where(grows, labels, -1)
    # labeled pixels of NON-model regions keep their label and never absorb
    grows_static = (labels >= 0) & ~grows

    lab_grow, _rounds = grow_labels(
        lab_grow.contiguous(), mod_n.contiguous(), mod_d.contiguous(), grows_static.contiguous(),
        valid_xyz.contiguous(), p.contiguous(), distance_threshold, max_sweeps)
    return torch.where(grows_static, labels, lab_grow)


def grow_labels_plain(lab_grow, mod_n, mod_d, grows_static, valid_xyz, p, distance_threshold, max_sweeps):
    """The refinement's growth loop in plain torch ops, a host loop on
    ``any(grow)`` (the JAX ``while_loop``, planes_seg.py:313), on the
    tensors' device. Returns (labels, the rounds it ran: the last one grew
    nothing, unless ``max_sweeps`` cut the loop)."""
    s, h, w = lab_grow.shape
    dev = lab_grow.device
    rounds = 0
    for _ in range(max_sweeps):
        rounds += 1
        best = torch.full((s, h, w), -1, dtype=lab_grow.dtype, device=dev)
        best_n = torch.zeros((s, h, w, 3), device=dev)
        best_d = torch.zeros((s, h, w), device=dev)
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            cand = _shift(lab_grow, dr, dc, -1)
            n_c = _shift(mod_n, dr, dc, 0.0)
            d_c = _shift(mod_d, dr, dc, 0.0)
            fit = torch.abs(dot3(n_c, p) - d_c) < distance_threshold
            take = (cand >= 0) & fit & (cand > best)
            best = torch.where(take, cand, best)
            best_n = torch.where(take[..., None], n_c, best_n)
            best_d = torch.where(take, d_c, best_d)
        grow = (lab_grow < 0) & ~grows_static & valid_xyz & (best >= 0)
        lab_grow = torch.where(grow, best, lab_grow)
        mod_n = torch.where(grow[..., None], best_n, mod_n)
        mod_d = torch.where(grow, best_d, mod_d)
        if not bool(grow.any()):
            break
    timing.count(REFINE, "host_loop")
    timing.count(REFINE, "host_rounds", rounds)
    return lab_grow, rounds


def grow_labels(lab_grow, mod_n, mod_d, grows_static, valid_xyz, p, distance_threshold=DISTANCE_THRESHOLD,
                max_sweeps=None):
    """The refinement's growth loop to its fixed point: each valid pixel
    that is neither labelled (``lab_grow`` < 0) nor in a non-model region
    (``grows_static``) takes the largest adjacent label whose plane
    (``mod_n``, ``mod_d``: each pixel's own) fits its point ``p`` within
    ``distance_threshold``, with that plane, round after round.

    lab_grow (S, H, W) int32; mod_n, p (S, H, W, 3) and mod_d (S, H, W)
    float32; grows_static, valid_xyz (S, H, W) bool; max_sweeps the
    backstop (default H * W). Returns (labels (S, H, W), rounds). CPU
    tensors run ``grow_labels_plain`` (rounds an int). CUDA tensors run
    csrc/planes_refine.cu in one launch, with no host read, or raise;
    rounds is then a device int32 (S,) tensor, the rounds each sensor ran,
    for tests and tools: the frame path never reads it."""
    if max_sweeps is None:
        max_sweeps = lab_grow.shape[1] * lab_grow.shape[2]
    if lab_grow.device.type == "cpu":
        return grow_labels_plain(lab_grow, mod_n, mod_d, grows_static, valid_xyz, p, distance_threshold, max_sweeps)
    return _launch_grow(lab_grow, mod_n, mod_d, grows_static, valid_xyz, p, distance_threshold, max_sweeps)


def _launch_grow(lab_grow, mod_n, mod_d, grows_static, valid_xyz, p, distance_threshold, max_sweeps):
    """Run csrc/planes_refine.cu on CUDA tensors; raise on any failure."""
    from rgbd360_torch.kernels.build import load_library

    if lab_grow.dim() != 3 or lab_grow.numel() == 0:
        raise ValueError(f"lab_grow must be a non-empty (S, H, W), got {tuple(lab_grow.shape)}")
    s, h, w = lab_grow.shape
    want = ((lab_grow, "lab_grow", (s, h, w), torch.int32), (mod_n, "mod_n", (s, h, w, 3), torch.float32),
            (mod_d, "mod_d", (s, h, w), torch.float32), (grows_static, "grows_static", (s, h, w), torch.bool),
            (valid_xyz, "valid_xyz", (s, h, w), torch.bool), (p, "p", (s, h, w, 3), torch.float32))
    for t, name, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != lab_grow.device:
            raise ValueError(f"{name} lies on {t.device}, lab_grow on {lab_grow.device}: one device for all")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= max_sweeps < 2**31 or h * w >= 2**31:
        raise ValueError(f"max_sweeps {max_sweeps} or {h} x {w} pixels out of the kernel's int32 range")
    dev = lab_grow.device
    out = torch.empty_like(lab_grow)
    rounds = torch.empty(s, dtype=torch.int32, device=dev)
    # the kernel's state: two int32 buffers a sensor (csrc/planes_refine.cu)
    scratch = torch.empty((s, 2, h * w), dtype=torch.int32, device=dev)
    lib = load_library()
    # <<<grid, block, smem, stream>>> launches on the calling thread's
    # current device: make it the tensors' card
    with torch.cuda.device_of(lab_grow):
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (lab_grow, mod_n, mod_d, grows_static, valid_xyz, p, out,
                                                        rounds, scratch)]
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.rgbd360_refine_grow(*ptrs[:6], ctypes.c_float(distance_threshold), max_sweeps, s, h, w, *ptrs[6:],
                                      stream)
    if err != 0:
        raise RuntimeError(f"planes_refine kernel launch failed: cudaError_t {err}")
    timing.count(REFINE, "kernel")
    return out, rounds
