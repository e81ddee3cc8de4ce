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

The SLAM state is host data in both packages: plane sets (PbMap), the
keyframe map (Map360), the topological SSO state and the pose graph. The
``*_from_numpy`` functions below copy the JAX package's objects field by
field (their fields are numpy arrays and Python scalars) into the port's
classes, so that a test runs both packages on identical state.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from rgbd360_torch.core.graph_optimizer import Edge, GraphOptimizer
from rgbd360_torch.core.map360 import Map360
from rgbd360_torch.core.pbmap import PbMap, Plane
from rgbd360_torch.core.topological import TopologicalMap360
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


def _copy(x):
    return copy.deepcopy(x)


def pbmap_from_numpy(pbmap) -> PbMap:
    """A JAX ``PbMap`` (or a list of its planes) -> the port's PbMap, each
    Plane copied field by field (the two dataclasses have the same fields)."""
    planes = pbmap.planes if hasattr(pbmap, "planes") else pbmap
    return PbMap([Plane(**{f.name: _copy(getattr(p, f.name)) for f in dataclasses.fields(Plane)}) for p in planes])


def map_from_numpy(world, frames) -> Map360:
    """A JAX ``Map360`` -> the port's, holding ``frames`` (the port's frames
    of the same keyframes, in order) with the JAX frames' id, node and pose;
    poses, increments, connections and areas copied."""
    out = Map360()
    for frame, j_frame in zip(frames, world.frames):
        frame.id, frame.node, frame.pose = j_frame.id, j_frame.node, np.array(j_frame.pose)
    out.frames = list(frames)
    out.trajectory_poses = [np.array(p) for p in world.trajectory_poses]
    out.optimized_poses = [np.array(p) for p in world.optimized_poses]
    out.trajectory_increments = [float(x) for x in world.trajectory_increments]
    out.connection_kfs = {
        int(k2): {int(k1): (np.array(rel), np.array(info)) for k1, (rel, info) in conns.items()}
        for k2, conns in world.connection_kfs.items()
    }
    out.areas = [set(a) for a in world.areas]
    out.neighbor_areas = [set(a) for a in world.neighbor_areas]
    out.selected_kfs = [int(k) for k in world.selected_kfs]
    out.current_area = int(world.current_area)
    return out


def topo_from_numpy(topo, world: Map360) -> TopologicalMap360:
    """A JAX ``TopologicalMap360``'s SSO state over the port's ``world``."""
    out = TopologicalMap360(world)
    out.v_sso = [np.array(m) for m in topo.v_sso]
    out.neig_sso = {tuple(k): np.array(b) for k, b in topo.neig_sso.items()}
    return out


def optimizer_from_numpy(opt) -> GraphOptimizer:
    """A JAX ``GraphOptimizer`` -> the port's: settings, vertices, edges."""
    out = GraphOptimizer(opt.rigidity, opt.planar_axis, opt.robust)
    out.vertices = [np.array(v) for v in opt.vertices]
    out.edges = [Edge(int(e.i), int(e.j), np.array(e.z), np.array(e.info)) for e in opt.edges]
    return out
