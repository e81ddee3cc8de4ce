"""State carried between the JAX package and the port (no JAX counterpart).

The dense aligner has no weights: its carried state is the pyramid sets,
the per-level ``LevelData``, the poses and the ``AlignResult``. These
functions take the JAX package's structures as numpy arrays (``np.asarray``
of each leaf — this module never imports jax) and return the port's
tensors on a given device, and turn the port's ``AlignResult`` back into
numpy. With them a test feeds the same pyramids to both aligners and tells
image-op drift apart from aligner drift.

A JAX pyramid set is a tuple of per-level lists, (gray, depth) for a
source and (gray, depth, ggx, ggy, dgx, dgy) for a target
(rgbd360_tpu/ops/photoicp.py:86). Each level is (H, W) for one pair or
(B, H, W) for a batch (the vmapped call); the port always carries the pair
axis, so a single pair gains B = 1.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd360_torch.ops.photoicp import AlignResult, LevelData


def _tensor(x, device, batched: bool) -> torch.Tensor:
    t = torch.from_numpy(np.array(x)).to(device)  # np.array: a writable, contiguous copy
    return t if batched else t[None]


def pyramids_from_numpy(src_pyrs, trg_pyrs, device, batched: bool = False):
    """JAX pyramid sets (numpy leaves) -> the port's (B, H, W) pyramid sets.
    batched: the levels already lead with a pair axis."""
    conv = lambda pyrs: tuple([_tensor(lv, device, batched) for lv in part] for part in pyrs)
    return conv(src_pyrs), conv(trg_pyrs)


def level_from_numpy(level, device, batched: bool = False) -> LevelData:
    """A JAX ``LevelData`` (numpy fields) -> the port's, with the pair axis."""
    return LevelData(*[_tensor(f, device, batched) for f in level])


def pose_from_numpy(pose, device) -> torch.Tensor:
    """(4, 4) or (B, 4, 4) pose(s) -> (B, 4, 4) f32."""
    p = np.asarray(pose, np.float32)
    return _tensor(p, device, p.ndim == 3)


def align_result_to_numpy(res: AlignResult, squeeze: bool = False) -> dict:
    """The port's AlignResult -> dict of numpy arrays under the field
    names, read from the device in one transfer per field. squeeze drops a
    pair axis of size 1, giving the single-pair JAX layout."""
    out = {}
    for name, value in res._asdict().items():
        a = value.detach().cpu().numpy()
        out[name] = a[0] if squeeze and a.shape[0] == 1 else a
    return out
