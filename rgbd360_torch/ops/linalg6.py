"""Fixed-size 6x6 linear algebra for the Gauss-Newton systems, batched.

Counterpart of rgbd360_tpu/ops/linalg6.py. The normal equations are
symmetric (H = J^T J), so an unrolled Cholesky solves them and doubles as
the observability check (positive pivots == full rank, replacing the
reference's Eigen rank() test at include/RegisterPhotoICP.h:4682). Written
out scalar by scalar, as in JAX, and not through ``torch.linalg``: the
same operations in the same order keep the ``ok`` flags equal to the
reference package's, and nothing raises on an ill-posed batch member.
"""

from __future__ import annotations

import torch

N = 6


def cholesky6(H: torch.Tensor):
    """Unrolled Cholesky of symmetric (..., 6, 6). Returns (L, ok) with L a
    6x6 list of (...) tensors (linalg6.py:18). ok is False where a pivot is
    non-positive or non-finite; L is garbage there and must be gated."""
    zero = torch.zeros(H.shape[:-2], dtype=H.dtype, device=H.device)
    L = [[zero for _ in range(N)] for _ in range(N)]
    ok = torch.ones(H.shape[:-2], dtype=torch.bool, device=H.device)
    # made on the device by a fill: an upload from pageable memory would
    # wait for the stream, and could not be captured in a CUDA graph
    eps = torch.full((), 1e-30, dtype=H.dtype, device=H.device)
    for j in range(N):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        ok = ok & (s > 0) & torch.isfinite(s)
        d = torch.sqrt(torch.maximum(s, eps))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, N):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L, ok


def solve6_sym(H: torch.Tensor, b: torch.Tensor):
    """Solve H x = b for SPD H (linalg6.py:44). Returns (x, ok)."""
    L, ok = cholesky6(H)
    y = [None] * N
    for i in range(N):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * N
    for i in reversed(range(N)):
        s = y[i]
        for k in range(i + 1, N):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1), ok


def spd_well_posed(H: torch.Tensor, lam) -> torch.Tensor:
    """Cholesky of H + lam*diag(H) succeeds and H is finite (linalg6.py:64)."""
    Hd = H + lam * (torch.eye(N, dtype=H.dtype, device=H.device) * H)
    _, ok = cholesky6(Hd)
    return ok & torch.isfinite(H).all(dim=-1).all(dim=-1)


def logdet6_sym(H: torch.Tensor):
    """log|H| via Cholesky (linalg6.py:73)."""
    L, ok = cholesky6(H)
    diag = torch.stack([L[i][i] for i in range(N)], dim=-1)
    return 2.0 * torch.sum(torch.log(diag), dim=-1), ok


def inv6_sym(H: torch.Tensor):
    """Inverse of symmetric 6x6 via 6 solves (linalg6.py:80)."""
    cols = []
    ok = None
    for i in range(N):
        e = torch.zeros(H.shape[:-1], dtype=H.dtype, device=H.device)
        e[..., i] = 1.0
        x, ok = solve6_sym(H, e)
        cols.append(x)
    return torch.stack(cols, dim=-1), ok
