"""Map360 persistence — SLAM state checkpoint/resume.

The reference's checkpoint story is per-keyframe files (sphereCloud_%u.pcd +
spherePlanes_%u.pbmap, reference include/Frame360.h:313-330) plus trajectory
and g2o text dumps; apps restart from files (SURVEY.md §5 checkpoint/resume).
This module rounds that out into a resumable map: save_map writes every
keyframe (via Frame360.save) plus one map_state.npz holding poses,
increments, connections, areas, the topological SSO state, and the pose
graph; load_map reconstructs Map360 + GraphOptimizer (+ TopologicalMap360)
that the SLAM apps can keep appending to.

Counterpart of rgbd360_tpu/core/map_io.py: the same files, so a map saved
by either package loads into the other. Keyframes are saved and reloaded by
the port's Frame360.save / Frame360.load_keyframe; a reloaded keyframe's
panorama goes to ``device`` (the card unless the caller names another).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.core.graph_optimizer import GraphOptimizer
from rgbd360_torch.core.map360 import Map360
from rgbd360_torch.core.topological import TopologicalMap360


def save_map(
    world: Map360,
    out_dir: str,
    optimizer: GraphOptimizer = None,
    topo: Optional[TopologicalMap360] = None,
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    # snapshot under the mutex, write files outside it: per-keyframe disk
    # writes take seconds and must not stall the tracking/LC threads
    with world.mutex:
        frames = list(world.frames)
        trajectory_poses = [np.asarray(p) for p in world.trajectory_poses]
        optimized_poses = [np.asarray(p) for p in world.optimized_poses]
        increments = list(world.trajectory_increments)
        conn_rows = []  # (kf1, kf2) -> pose (16) + info (36)
        for kf1, conns in world.connection_kfs.items():
            for kf2, (rel, info) in conns.items():
                conn_rows.append(
                    np.concatenate(
                        [[kf1, kf2], np.asarray(rel, np.float64).ravel(),
                         np.asarray(info, np.float64).ravel()]
                    )
                )
        areas = [sorted(a) for a in world.areas]
        neighbor_areas = [sorted(a) for a in world.neighbor_areas]
        selected_kfs = list(world.selected_kfs)
        current_area = world.current_area
        sso_blocks = {}
        if topo is not None:
            sso_blocks["v_sso"] = np.array(
                [np.asarray(m, np.float32) for m in topo.v_sso], dtype=object
            )
            sso_blocks["neig_sso_keys"] = np.array(
                sorted(topo.neig_sso.keys()), np.int64
            ).reshape(-1, 2)
            sso_blocks["neig_sso_blocks"] = np.array(
                [np.asarray(topo.neig_sso[k], np.float32) for k in sorted(topo.neig_sso)],
                dtype=object,
            )

    for kf_id, frame in enumerate(frames):
        frame.save(out_dir, kf_id)
    np.savez_compressed(
        os.path.join(out_dir, "map_state.npz"),
        n_keyframes=len(frames),
        trajectory_poses=np.stack(trajectory_poses) if frames else np.zeros((0, 4, 4)),
        optimized_poses=np.stack(optimized_poses) if optimized_poses else np.zeros((0, 4, 4)),
        trajectory_increments=np.asarray(increments),
        connections=np.stack(conn_rows) if conn_rows else np.zeros((0, 54)),
        areas=np.array(areas, dtype=object),
        neighbor_areas=np.array(neighbor_areas, dtype=object),
        selected_kfs=np.asarray(selected_kfs, np.int64),
        current_area=current_area,
        **sso_blocks,
    )
    if optimizer is not None:
        optimizer.save_graph(os.path.join(out_dir, "pose_graph.g2o"))


def load_map(
    out_dir: str, calib, device=None
) -> Tuple[Map360, GraphOptimizer]:
    world, optimizer, _topo = load_map_full(out_dir, calib, device)
    return world, optimizer


def load_map_full(
    out_dir: str, calib, device=None
) -> Tuple[Map360, GraphOptimizer, TopologicalMap360]:
    """Reconstruct map + optimizer + topological SSO state. Without the SSO
    arrays the first post-resume keyframe's add_connection would index an
    empty v_sso and crash; checkpoints written before the SSO state was
    persisted fall back to correctly-sized zero matrices (degraded
    affinities, no crash)."""
    world = Map360()
    optimizer = GraphOptimizer(robust=True)  # match the SLAM apps' default
    with np.load(os.path.join(out_dir, "map_state.npz"), allow_pickle=True) as z:
        payload = {k: z[k] for k in z.files}

    n = int(payload["n_keyframes"])
    areas = [set(int(i) for i in a) for a in payload["areas"]]
    neighbor_areas = [set(int(i) for i in a) for a in payload["neighbor_areas"]]
    trajectory = payload["trajectory_poses"]
    optimized = payload["optimized_poses"]
    have_optimized = len(optimized) == n

    for kf_id in range(n):
        frame = Frame360.load_keyframe(calib, out_dir, kf_id, device)
        frame.id = kf_id
        frame.node = next((a for a, s in enumerate(areas) if kf_id in s), 0)
        frame.pose = trajectory[kf_id].astype(np.float32)
        world.frames.append(frame)
        world.trajectory_poses.append(trajectory[kf_id].astype(np.float32))
        # seed vertices from the checkpointed OPTIMIZED estimates when they
        # exist — re-initializing from raw odometry would discard the saved
        # loop-closure corrections until the next optimize_graph reconverges
        seed = optimized[kf_id] if have_optimized else trajectory[kf_id]
        optimizer.add_vertex(np.asarray(seed, np.float64))
    world.trajectory_increments = [float(x) for x in payload["trajectory_increments"]]
    world.optimized_poses = [p.astype(np.float32) for p in optimized]
    world.areas = areas
    world.neighbor_areas = neighbor_areas
    world.selected_kfs = [int(x) for x in payload["selected_kfs"]]
    world.current_area = int(payload["current_area"])
    for row in payload["connections"]:
        kf1, kf2 = int(row[0]), int(row[1])
        rel = row[2:18].reshape(4, 4)
        info = row[18:54].reshape(6, 6)
        world.connection_kfs.setdefault(kf1, {})[kf2] = (
            rel.astype(np.float32),
            info.astype(np.float32),
        )
        optimizer.add_edge(kf2, kf1, rel, info)

    topo = TopologicalMap360(world)
    if "v_sso" in payload:
        topo.v_sso = [np.asarray(m, np.float32) for m in payload["v_sso"]]
        keys = payload["neig_sso_keys"].reshape(-1, 2)
        blocks = payload["neig_sso_blocks"]
        topo.neig_sso = {
            (int(k[0]), int(k[1])): np.asarray(b, np.float32)
            for k, b in zip(keys, blocks)
        }
    else:  # pre-SSO checkpoint: correctly-sized zero affinities
        topo.v_sso = [
            np.zeros((len(a), len(a)), np.float32) for a in world.areas
        ] or [np.zeros((0, 0), np.float32)]
        topo.neig_sso = {}
    return world, optimizer, topo
