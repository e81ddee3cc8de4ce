"""Integral-image surface normals for organized clouds.

Counterpart of rgbd360_tpu/ops/normals.py: PCL IntegralImageNormalEstimation
in AVERAGE_3D_GRADIENT mode as the reference configures it
(include/Frame360.h:949-967: smoothing 8, max depth change 0.02,
depth-dependent smoothing). Central-difference 3D gradients along image x and
y are box-averaged (validity-aware, from cumulative-sum integral images) and
the normal is their normalized cross product, flipped toward the viewpoint.
Pixels whose window straddles a depth discontinuity larger than
max_depth_change*depth are rejected; where the full window is
edge-dominated, a window shrunk to the chessboard distance to the nearest
discontinuity fills in.

The JAX function takes one (H, W, 3) cloud and is vmapped; this one takes
(S, H, W, 3).

The integral images are f32 running sums in the association XLA gives
jnp.cumsum on the CPU (its reduce-window rewrite): chunks of 16 summed in
index order, plus the running sum of the chunk totals. torch.cumsum is
neither that nor a plain f32 loop (on the CPU it accumulates in f64, on the
card it is a parallel scan), and the box sums subtract cumulative sums of
thousands of gradients, so the rounding reaches the normals well past the
1e-5 that tests/test_torch_planes.py holds them to.
"""

from __future__ import annotations

import torch


_CHUNK = 16


def _running_sum(x: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Running sum along the last axis, one f32 add per step in index order
    (a reduce-window of XLA, whose window pads add zeros first)."""
    out = torch.zeros_like(x) if exclusive else x.clone()
    for i in range(1, x.shape[-1]):
        out[..., i] = out[..., i - 1] + x[..., i - 1 if exclusive else i]
    return out


def _cumsum_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.cumsum along ``dim`` with XLA's CPU association: zero-pad the axis
    to a multiple of 16, running sums inside each chunk of 16, plus the
    exclusive running sum of the chunk totals (itself split the same way
    when there are more than 16 chunks)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    nc = -(-n // _CHUNK)
    chunks = torch.nn.functional.pad(x, (0, nc * _CHUNK - n)).reshape(*x.shape[:-1], nc, _CHUNK)
    inner = _running_sum(chunks)
    totals = inner[..., -1]
    if nc <= _CHUNK:
        before = _running_sum(totals, exclusive=True)
    else:
        before = torch.nn.functional.pad(_cumsum_xla(totals, -1)[..., :-1], (1, 0))
    out = (inner + before[..., None]).reshape(*x.shape[:-1], nc * _CHUNK)[..., :n]
    return out.movedim(-1, dim)


def _integral_image(img: torch.Tensor) -> torch.Tensor:
    """(S, H, W, C) -> padded 2D cumulative sum (S, H+1, W+1, C)
    (normals.py:22)."""
    ii = _cumsum_xla(_cumsum_xla(img, 1), 2)
    return torch.nn.functional.pad(ii, (0, 0, 1, 0, 1, 0))


def _box_from_ii(ii: torch.Tensor, r: int, h: int, w: int) -> torch.Tensor:
    """Sum over a (2r+1)^2 window from a padded integral image."""
    dev = ii.device
    y0 = torch.clamp(torch.arange(h, device=dev) - r, 0, h)
    y1 = torch.clamp(torch.arange(h, device=dev) + r + 1, 0, h)
    x0 = torch.clamp(torch.arange(w, device=dev) - r, 0, w)
    x1 = torch.clamp(torch.arange(w, device=dev) + r + 1, 0, w)
    rows1, rows0 = ii[:, y1], ii[:, y0]
    return rows1[:, :, x1] - rows1[:, :, x0] - rows0[:, :, x1] + rows0[:, :, x0]


def _box_sum_var(ii: torch.Tensor, r_px: torch.Tensor, r_max: int, h: int, w: int) -> torch.Tensor:
    """Sum over a per-pixel (2*r_px+1)^2 window, r_px in [1, r_max]: r_max
    static box sums from one integral image and a select chain
    (normals.py:43)."""
    out = _box_from_ii(ii, 1, h, w)
    for rr in range(2, r_max + 1):
        out = torch.where((r_px == rr)[..., None], _box_from_ii(ii, rr, h, w), out)
    return out


# XLA's CPU code contracts a multiply feeding an add into one fused
# multiply-add. The plane layer's threshold predicates (edge, fit, flip)
# and its normals see that rounding, so the 3-vector products below are
# written the way XLA fuses them, with torch.addcmul (a fused multiply-add
# on the CPU). With plain products a few segmentation edges of a synthetic
# room frame fell on the other side of their threshold than in JAX.


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis (size 3): the first product rounded, then
    two fused multiply-adds."""
    return torch.addcmul(torch.addcmul(a[..., 0] * b[..., 0], a[..., 1], b[..., 1]), a[..., 2], b[..., 2])


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis: each component fma(x, y, -(z * w))."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [torch.addcmul(-(a2 * b1), a1, b2), torch.addcmul(-(a0 * b2), a2, b0), torch.addcmul(-(a1 * b0), a0, b1)],
        dim=-1,
    )


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(v, v))[..., None]


def organized_normals(xyz: torch.Tensor, smoothing: int = 8, max_depth_change: float = 0.02) -> torch.Tensor:
    """xyz: (S, H, W, 3) with NaN invalid. Returns normals (S, H, W, 3) f32,
    NaN where invalid (normals.py:63)."""
    s, h, w, _ = xyz.shape
    dev = xyz.device
    valid = torch.isfinite(xyz).all(-1)
    zero = torch.zeros((), device=dev)
    p = torch.where(valid[..., None], xyz, zero)

    # central-difference 3D gradients (invalid where either neighbour invalid)
    gx = torch.zeros_like(p)
    gx[:, :, 1:-1] = p[:, :, 2:] - p[:, :, :-2]
    gx_ok = torch.zeros_like(valid)
    gx_ok[:, :, 1:-1] = valid[:, :, 2:] & valid[:, :, :-2]
    gy = torch.zeros_like(p)
    gy[:, 1:-1] = p[:, 2:] - p[:, :-2]
    gy_ok = torch.zeros_like(valid)
    gy_ok[:, 1:-1] = valid[:, 2:] & valid[:, :-2]

    # depth-discontinuity map: neighbour z jumps beyond max_depth_change*z
    z = xyz[..., 2]
    thr = torch.clamp(max_depth_change * torch.where(valid, z, torch.ones((), device=dev)), min=max_depth_change)
    jump_x = torch.zeros_like(valid)
    jump_x[:, :, 1:-1] = (torch.abs(z[:, :, 2:] - z[:, :, 1:-1]) > thr[:, :, 1:-1]) | (
        torch.abs(z[:, :, 1:-1] - z[:, :, :-2]) > thr[:, :, 1:-1]
    )
    jump_y = torch.zeros_like(valid)
    jump_y[:, 1:-1] = (torch.abs(z[:, 2:] - z[:, 1:-1]) > thr[:, 1:-1]) | (
        torch.abs(z[:, 1:-1] - z[:, :-2]) > thr[:, 1:-1]
    )
    edge = (jump_x | jump_y) & valid
    clean = valid & ~edge

    r = smoothing // 2
    okx, oky = gx_ok & clean, gy_ok & clean
    feats = torch.cat(
        [torch.where(okx[..., None], gx, zero), torch.where(oky[..., None], gy, zero),
         okx.to(torch.float32)[..., None], oky.to(torch.float32)[..., None]],
        dim=-1,
    )  # (S, H, W, 8): one integral image for both window types

    # primary path: the full fixed window, accepted when a supermajority of
    # it is edge-free
    ii = _integral_image(feats)
    box = _box_from_ii(ii, r, h, w)
    win = float((2 * r + 1) ** 2)
    normal = cross3(box[..., 0:3], box[..., 3:6])
    norm = _norm(normal)
    ok = clean & (box[..., 6] > 0.6 * win) & (box[..., 7] > 0.6 * win) & (norm[..., 0] > 1e-12)

    # fill-in path: the window shrunk to the chessboard distance to the
    # nearest discontinuity (r sweeps of 3x3 min+1, exact up to r)
    far = float(r + 1)
    dist = torch.where(edge, zero, torch.full((), far, device=dev))
    for _ in range(r):
        pd = torch.nn.functional.pad(dist, (1, 1, 1, 1), value=far)
        m = pd[:, 0:h, 0:w]
        for dy in range(3):
            for dx in range(3):
                m = torch.minimum(m, pd[:, dy : dy + h, dx : dx + w])
        dist = torch.minimum(dist, m + 1.0)
    r_px = torch.clamp(dist - 1.0, 1.0, float(r)).to(torch.int32)
    box_s = _box_sum_var(ii, r_px, r, h, w)
    normal_s = cross3(box_s[..., 0:3], box_s[..., 3:6])
    norm_s = _norm(normal_s)
    ok_s = clean & (box_s[..., 6] >= 2.0) & (box_s[..., 7] >= 2.0) & (norm_s[..., 0] > 1e-12)

    use_fill = ~ok & ok_s
    normal = torch.where(use_fill[..., None], normal_s, normal)
    norm = torch.where(use_fill[..., None], norm_s, norm)
    ok = ok | ok_s

    normal = normal / torch.clamp(norm, min=1e-12)
    # flip toward the viewpoint (sensor at origin): n . p < 0
    flip = dot3(normal, p) > 0
    normal = torch.where(flip[..., None], -normal, normal)
    return torch.where(ok[..., None], normal, torch.full((), float("nan"), device=dev))
