"""Fast bilateral filter on the z channel of an organized cloud.

Counterpart of rgbd360_tpu/ops/bilateral.py: PCL's FastBilateralFilter
(Paris & Durand bilateral grid) with sigma_s=10 px, sigma_r=0.05 m
(reference include/Frame360.h:417-430, 493-499); only z is filtered.

Grid ~ (H/10+5, W/10+5, 205): splat the homogeneous (z, 1), blur each grid
axis with [1 2 1]/4, slice trilinearly. The splat is JAX's dense one-hot
contraction (every pixel's spatial cell is fixed by the pixel grid, only
its depth bin depends on the data), two matmuls in full f32 (the package
keeps TF32 off, the counterpart of precision=HIGHEST). The slice contracts
two-hot weight rows, so each output is a two-term sum; it is computed as
that sum, in XLA's order and with its fused multiply-add
(``torch.addcmul``): round(w0 * a) then fma(w1, b, .), row pair, then
column pair, then depth pair. That gives JAX's slice bit for bit and never
builds the (S, H, W, 205, 2) upsampled grid. The splat's second matmul
sums in another order than XLA's dot, so outputs can differ in the last
few ulps. The JAX function takes one sensor and is vmapped; this one takes
(S, H, W). At (8, 120, 160) the dense splat is about 250 MB in f32, freed
once contracted.
"""

from __future__ import annotations

import torch

SIGMA_S = 10.0
SIGMA_R = 0.05
_PAD = 2


def _blur_axis(grid: torch.Tensor, axis: int) -> torch.Tensor:
    lo = torch.roll(grid, 1, axis)
    hi = torch.roll(grid, -1, axis)
    return 0.25 * lo + 0.5 * grid + 0.25 * hi


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, dtype=idx.dtype, device=idx.device)).to(torch.float32)


def fast_bilateral_z(z: torch.Tensor) -> torch.Tensor:
    """z: (S, H, W) f32 with NaN invalid. Returns filtered z (NaN
    preserved) (bilateral.py:33)."""
    s, h, w = z.shape
    dev = z.device
    valid = torch.isfinite(z)
    zv = torch.where(valid, z, torch.zeros((), device=dev))
    zmin = torch.where(valid, z, torch.full((), float("inf"), device=dev)).amin(dim=(1, 2))
    zmin = torch.where(torch.isfinite(zmin), zmin, torch.zeros((), device=dev))

    gh = int(round(h / SIGMA_S)) + 1 + 2 * _PAD
    gw = int(round(w / SIGMA_S)) + 1 + 2 * _PAD
    gd = 200 + 1 + 2 * _PAD  # depth range bins: generous static bound (10 m / 0.05)

    # XLA folds the division by SIGMA_S into a multiply by its f32
    # reciprocal; the port does the same so the cell weights agree
    y1d = torch.arange(h, dtype=torch.float32, device=dev) * (1.0 / SIGMA_S) + _PAD
    x1d = torch.arange(w, dtype=torch.float32, device=dev) * (1.0 / SIGMA_S) + _PAD
    # clamped into the static grid span, as the splat's bin clip
    dd = torch.clamp((zv - zmin[:, None, None]) / SIGMA_R + _PAD, 0.0, float(200 + _PAD))
    # torch.round rounds half to even, as jnp.round
    yi = torch.clamp(torch.round(y1d).to(torch.int32), 0, gh - 1)
    xi = torch.clamp(torch.round(x1d).to(torch.int32), 0, gw - 1)
    di = torch.clamp(torch.round(dd).to(torch.int32), 0, gd - 1)

    # splat: bin densely over depth, contract the pixel axes with the static
    # 0/1 cell-membership matrices
    ohf = _one_hot(di, gd) * valid[..., None]  # (S, h, w, gd)
    dense = torch.stack([ohf * zv[..., None], ohf], dim=-1)  # (S, h, w, gd, 2)
    del ohf
    sy = _one_hot(yi, gh)  # (h, gh)
    sx = _one_hot(xi, gw)  # (w, gw)
    grid = torch.matmul(sy.T, dense.reshape(s, h, w * gd * 2))  # (S, gh, w*gd*2)
    del dense
    grid = torch.matmul(sx.T, grid.reshape(s * gh, w, gd * 2))  # (S*gh, gw, gd*2)
    grid = grid.reshape(s, gh, gw, gd, 2)
    for axis in (1, 2, 3):
        grid = _blur_axis(grid, axis)

    # slice: the two-hot rows over y, then x, then the depth bins
    y0r = torch.clamp(torch.floor(y1d).to(torch.int64), 0, gh - 2)
    x0c = torch.clamp(torch.floor(x1d).to(torch.int64), 0, gw - 2)
    fy1 = (y1d - y0r)[None, :, None, None, None]
    fx1 = x1d - x0c
    up_y = torch.addcmul((1 - fy1) * grid[:, y0r], fy1, grid[:, y0r + 1])  # (S, h, gw, gd, 2)
    del grid
    z0 = torch.clamp(torch.floor(dd).to(torch.int64), 0, gd - 2)
    fz = dd - z0
    si = torch.arange(s, device=dev)[:, None, None]
    ri = torch.arange(h, device=dev)[None, :, None]
    xc = x0c[None, None, :]
    fx = fx1[None, None, :, None]

    def up_at(zbin):  # the x-contracted grid at depth bin zbin: (S, h, w, 2)
        return torch.addcmul((1 - fx) * up_y[si, ri, xc, zbin], fx, up_y[si, ri, xc + 1, zbin])

    acc = torch.addcmul((1 - fz)[..., None] * up_at(z0), fz[..., None], up_at(z0 + 1))
    num, den = acc[..., 0], acc[..., 1]
    zf = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12), z)
    return torch.where(valid, zf, z)
