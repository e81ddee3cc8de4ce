"""Multi-GPU scale-out of the pair axis.

Counterpart of rgbd360_tpu/parallel/mesh.py. The workload's parallel
structure (SURVEY.md §2.3): independent frame-pair registrations scale
data-parallel over devices; map-level ops (the loop-closure refinement, the
relocalize / loop-closure candidate sweeps) batch the same way. Nothing is
sharded but the pair (or candidate) axis, and no collective is needed: a
pair's Gauss-Newton system never leaves its device.

A mesh is an ordered list of ``torch.device``. The JAX package places the
pair axis under shard_map; here each shard runs ``align_batch`` in a thread
of its own, on a stream of its own, because every Gauss-Newton iteration
syncs with the host once (the loop condition): one thread per shard lets
the shards' device work overlap those syncs. Each pair is reduced on its
own (ops/photoicp.py::_pair_grams), so a split result is bit-equal to the
unsplit call on the same device type.

``make_mesh()`` spans every visible card; a list of devices may repeat one
(``[cuda:0, cuda:0]``, ``[cpu, cpu]``), the analogue of the JAX dry run's
virtual devices.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from rgbd360_torch.device import require_cuda
from rgbd360_torch.ops import photoicp
from rgbd360_torch.parallel.batch import align_batch


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of the pair axis, in shard order: every visible CUDA
    device unless ``devices`` names them (raises when there is no card)."""
    if devices is None:
        require_cuda()
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def pair_devices(device: torch.device) -> List[torch.device]:
    """The devices a batch on ``device`` may split over: every visible card
    for a CUDA device, ``device`` alone otherwise."""
    return make_mesh() if torch.device(device).type == "cuda" else [torch.device(device)]


def split_pairs(mesh: Sequence[torch.device], *tensors: torch.Tensor):
    """Per tensor, ``len(mesh)`` contiguous slices of the leading axis (the
    first ones one longer when it does not divide), each moved to its
    device."""
    out = []
    for t in tensors:
        sizes = [len(ix) for ix in np.array_split(np.arange(t.shape[0]), len(mesh))]
        out.append([part.to(dev) for part, dev in zip(torch.split(t, sizes), mesh)])
    return tuple(out)


def shard_pairs(mesh: Sequence[torch.device], *tensors: torch.Tensor):
    """Per tensor, a list of equal contiguous slices of the leading pair
    axis, each on its device. The batch must divide by the mesh size (as
    JAX's NamedSharding requires)."""
    for t in tensors:
        if t.shape[0] % len(mesh):
            raise ValueError(f"batch {t.shape[0]} does not divide over {len(mesh)} devices")
    return split_pairs(mesh, *tensors)


def align_shards(mesh: Sequence[torch.device], *shards, **kwargs) -> photoicp.AlignResult:
    """``align_batch(*shard, **kwargs)`` for each shard (``shards`` as
    split_pairs returns them: per operand, one tensor per device), each in
    a thread of its own and, on a card, on a stream of its own. Returns the
    shards' results concatenated on ``mesh[0]`` in pair order. A shard's
    failure is raised here."""
    results: list = [None] * len(mesh)
    errors: list = []
    # the streams that produced the shards: each shard's stream waits on its
    # device's, and the caller's stream of mesh[0] on every shard's
    callers = [torch.cuda.current_stream(d) if d.type == "cuda" else None for d in mesh]

    def run(k: int) -> None:
        dev = mesh[k]
        args = [operand[k] for operand in shards]
        try:
            if dev.type != "cuda":
                results[k] = align_batch(*args, **kwargs)
                return
            with torch.cuda.device(dev):
                stream = torch.cuda.Stream(dev)
                stream.wait_stream(callers[k])
                with torch.cuda.stream(stream):
                    results[k] = align_batch(*args, **kwargs)
                stream.synchronize()
        except BaseException as exc:  # re-raised by the caller's thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(k,), name=f"align_shard_{k}") for k in range(len(mesh))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return photoicp.AlignResult(*[
        torch.cat([getattr(r, field).to(mesh[0]) for r in results]) for field in photoicp.AlignResult._fields
    ])


def align_batch_sharded(
    mesh: Sequence[torch.device],
    gray_src: torch.Tensor,
    depth_src: torch.Tensor,
    gray_trg: torch.Tensor,
    depth_trg: torch.Tensor,
    pose_guess: torch.Tensor,
    method: int = photoicp.PHOTO_DEPTH,
    n_levels: int = 5,
    need_stats: bool = True,
    full_coverage: bool = False,
) -> photoicp.AlignResult:
    """Data-parallel batched registration (mesh.py:66): the pair axis split
    evenly over ``mesh`` (it must divide), one ``align_batch`` per shard.
    Every field of the result leads with the pair axis, on ``mesh[0]``."""
    shards = shard_pairs(mesh, gray_src, depth_src, gray_trg, depth_trg, pose_guess)
    return align_shards(
        mesh, *shards, method=method, n_levels=n_levels, need_stats=need_stats, full_coverage=full_coverage,
    )


def prefilter_candidates_sharded(mesh: Sequence[torch.device], frame_pbmap, cand_pbmaps, config, mode):
    """The relocalize / loop-closure candidate sweep with the candidate axis
    split over the mesh (mesh.py:91): the query's plane set goes to every
    device, each device scores its shard of candidates. The candidates are
    padded to a mesh multiple with copies of the first; the pads are sliced
    off the counts and areas. Equals core.batch_match.prefilter_candidates."""
    from rgbd360_torch.core.batch_match import (
        MAX_PLANES, compat_matrices, config_tuple, pack_pbmap, stack_packs, upload_packs,
    )

    n = len(cand_pbmaps)
    if n == 0:
        return np.zeros(0, int), np.zeros(0)
    packs = [pack_pbmap(p) for p in cand_pbmaps]
    packs += [pack_pbmap(cand_pbmaps[0])] * ((-n) % len(mesh))  # pad shard; sliced off below
    ref_pack, cfg = pack_pbmap(frame_pbmap), config_tuple(config)
    per = len(packs) // len(mesh)
    has = []
    for k, dev in enumerate(mesh):
        ref, trg = upload_packs(ref_pack, packs[k * per:(k + 1) * per], dev)
        compat = compat_matrices(ref, trg, cfg, mode)  # (per, Kf, Kc)
        has.append(torch.cat([compat.any(dim=2), compat.any(dim=1)], dim=1).cpu().numpy())
    has = np.concatenate(has)
    frame_has, cand_has = has[:, :MAX_PLANES], has[:, MAX_PLANES:]
    counts = np.minimum(frame_has.sum(axis=1), cand_has.sum(axis=1))
    areas = (cand_has * stack_packs(packs)["area"]).sum(axis=1)
    return counts[:n], areas[:n]
