"""Dry run of the pair mesh: every multi-device leg held to its unsplit call.

Counterpart of ``__graft_entry__.dryrun_multichip`` (its :90-260), which
runs the JAX package's sharded programs over virtual CPU devices. Here the
mesh is one device repeated ``n_devices`` times (``[cuda:0, cuda:0]`` on
the card, ``[cpu, cpu]`` on the CPU): each shard runs in its own thread on
its own stream, the way parallel/mesh.py drives several cards. The four
legs:

  1. the tracking-shaped align: PAIRS_PER_DEVICE pairs per device at
     32 x 192, 3 levels, each pair from its own yawed seed;
  2. the candidate prefilter with the keyframe axis split (padded to a
     mesh multiple);
  3. the loop-closure refinement leg, ``full_coverage=True``;
  4. the kernel under the mesh: levels that take the windowed gather.

On a CUDA device legs 3 and 4 run at 160 x 960, 2 levels, where every
level takes the kernel (>= WARP_KERNEL_MIN_PIXELS): leg 3 launches the
FULL form, leg 4 the pipelined pass and its DUAL exact-final. On the CPU
they run at 32 x 192 and leg 4 forces the windowed route at its finest
level, which runs the gather's plain version (as the JAX dry run forces the
route and runs the Pallas kernel in interpret mode).

Each align leg must be bit-equal to ``align_batch`` over the whole batch on
the same device, iteration counts included (the JAX dry run holds its legs
within 1e-5); the prefilter must equal ``batch_match.prefilter_candidates``.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd360_torch.device import resolve_device
from rgbd360_torch.ops import photoicp, warp_gather
from rgbd360_torch.parallel import mesh as pmesh
from rgbd360_torch.parallel.batch import align_batch

PAIRS_PER_DEVICE = 4
TRACK_SHAPE = (32, 192)  # divisible by 8 sensors and by 2^2 pyramid levels
KERNEL_SHAPE = (160, 960)  # both levels of a 2-level pyramid >= WARP_KERNEL_MIN_PIXELS


def synthetic_pair(h: int, w: int, batch: int):
    """(gray, depth) (batch, h, w) f32: the JAX dry run's smooth synthetic
    panorama (__graft_entry__.py:6), the same for every pair."""
    yy, xx = np.mgrid[0:h, 0:w]
    gray = (
        0.5
        + 0.2 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
        + 0.12 * np.sin(xx / 3.1)
        + 0.08 * np.cos(xx / 1.7 + yy / 2.3)
    ).astype(np.float32)
    depth = (2.0 + 0.6 * np.sin(xx / 13.0) + 0.3 * np.cos(yy / 8.0)).astype(np.float32)
    stack = lambda a: torch.from_numpy(np.broadcast_to(a, (batch, h, w)).copy())
    return stack(gray), stack(depth)


def yawed_seeds(batch: int) -> torch.Tensor:
    """(batch, 4, 4) f32 seeds: pair k turned by 0.01 k rad about the
    panorama's vertical axis, so that the pairs iterate differently."""
    seeds = np.tile(np.eye(4), (batch, 1, 1))
    for k in range(batch):
        c, s = np.cos(0.01 * k), np.sin(0.01 * k)
        seeds[k, 1:3, 1:3] = [[c, -s], [s, c]]
    return torch.from_numpy(seeds.astype(np.float32))


def assert_same_result(split: photoicp.AlignResult, whole: photoicp.AlignResult, leg: str) -> None:
    """Every field of ``split`` bit-equal to ``whole``'s."""
    for field in photoicp.AlignResult._fields:
        a, b = getattr(split, field).cpu(), getattr(whole, field).cpu()
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{leg}: the split {field} differs from the unsplit call's")


def _tiny_pbmap(offset: float):
    from rgbd360_torch.core.pbmap import PbMap, Plane

    planes = []
    for k in range(3):
        n = np.zeros(3, np.float32)
        n[k] = 1.0
        planes.append(Plane(id=k, normal=n, center=n * (1.0 + offset), d=-(1.0 + offset),
                            area_hull=2.0 + k, elongation=1.5))
    pb = PbMap()
    pb.planes = planes
    return pb


def _align_leg(mesh, dev, shape, n_levels, full_coverage, leg):
    """Sharded and unsplit align of the leg's batch; returns (the split
    result, its kernel launches, its sweeps), both counted across the
    shards' threads."""
    batch = PAIRS_PER_DEVICE * len(mesh)
    gray, depth = synthetic_pair(*shape, batch)
    gray, depth, seeds = gray.to(dev), depth.to(dev), yawed_seeds(batch).to(dev)
    kwargs = dict(n_levels=n_levels, full_coverage=full_coverage)
    warp_gather.reset_launch_counts()
    photoicp.reset_sweep_counts()
    split = pmesh.align_batch_sharded(mesh, gray, depth, gray, depth, seeds, **kwargs)
    launches, sweeps = dict(warp_gather.LAUNCHES), dict(photoicp.SWEEPS)
    whole = align_batch(gray, depth, gray, depth, seeds, **kwargs)
    assert_same_result(split, whole, leg)
    return split, launches, sweeps


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the four legs over ``n_devices`` shards of ``device`` (the card
    unless given). Raises on any disagreement; returns, per align leg, the
    kernel launches and sweeps of its split run."""
    dev = resolve_device(device)
    mesh = pmesh.make_mesh([dev] * n_devices)
    on_card = dev.type == "cuda"
    report = {}

    # 1. the tracking-shaped align; self-alignment from the identity stays put
    res, launches, sweeps = _align_leg(mesh, dev, TRACK_SHAPE, 3, False, "tracking leg")
    if not torch.equal(res.pose[0].cpu(), torch.eye(4)):
        raise AssertionError(f"tracking leg: self-alignment left the identity: {res.pose[0].tolist()}")
    report["tracking"] = {"launches": launches, "sweeps": sweeps, "iterations": res.num_iterations.tolist()}

    # 2. the candidate sweep with the keyframe axis split (n_devices + 3
    # candidates: the last shard is padded)
    from rgbd360_torch.core.batch_match import prefilter_candidates
    from rgbd360_torch.core.matcher import PLANAR_3DOF, MatcherConfig

    query = _tiny_pbmap(0.0)
    cands = [_tiny_pbmap(0.02 * i) for i in range(n_devices + 3)]
    counts, areas = pmesh.prefilter_candidates_sharded(mesh, query, cands, MatcherConfig(), PLANAR_3DOF)
    counts_ref, areas_ref = prefilter_candidates(query, cands, MatcherConfig(), PLANAR_3DOF, device=dev)
    if not (np.array_equal(counts, counts_ref) and np.array_equal(areas, areas_ref)):
        raise AssertionError(f"prefilter leg: {counts} {areas} vs the unsplit {counts_ref} {areas_ref}")
    report["prefilter"] = {"counts": counts.tolist()}

    # 3. the loop-closure refinement leg: full coverage in every sweep
    shape = KERNEL_SHAPE if on_card else TRACK_SHAPE
    res, launches, sweeps = _align_leg(mesh, dev, shape, 2, True, "loop-closure leg")
    report["lc"] = {"launches": launches, "sweeps": sweeps, "iterations": res.num_iterations.tolist()}

    # 4. the windowed gather under the mesh
    routed = photoicp._use_warp_kernel
    try:
        if not on_card:
            h, w = TRACK_SHAPE
            photoicp._use_warp_kernel = lambda level_shape, level_dev: level_shape[0] * level_shape[1] >= h * w
        res, launches, sweeps = _align_leg(mesh, dev, shape, 2, False, "kernel leg")
    finally:
        photoicp._use_warp_kernel = routed
    if sweeps["windowed"] == 0:
        raise AssertionError("kernel leg: no level took the windowed gather")
    report["kernel"] = {"launches": launches, "sweeps": sweeps, "iterations": res.num_iterations.tolist()}
    print(f"dryrun_multichip OK: {n_devices} shards of {dev}, {PAIRS_PER_DEVICE} pairs each; tracking, "
          f"loop-closure (full coverage) and kernel legs bit-equal to the unsplit call; prefilter counts "
          f"{counts.tolist()} equal", flush=True)
    return report
