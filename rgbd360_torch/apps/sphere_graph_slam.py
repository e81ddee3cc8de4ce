"""SphereGraphSLAM — hybrid plane/dense pose-graph SLAM
(reference SLAM/SphereGraphSLAM.cpp:60-302 + SLAM/KFsphere_SLAM.cpp):
PbMap tracking against up to 5 previous keyframes with dense refinement,
relocalization when tracking is lost, topological SSO upkeep, the batched
loop-closure search and refinement, robust pose-graph optimization, and
spectral re-partitioning every 4 keyframes. Every tracked frame becomes a
keyframe, as in the reference app (keyframe selection is kf_sphere_slam's).

Counterpart of rgbd360_tpu/apps/sphere_graph_slam.py. Frames come through
planes_pipeline over deferred frames (each frame's undistort, stitch and
plane statistics in one device program, the host plane fit on a worker
thread); the map keeps each keyframe's panorama on the device. Runs on the
card unless --device names another device. Each frame's line ends with its
wall time (the loop iteration, the next frame's pipeline work included).
--live-view DIR serves the map as it grows (utils/live_viewer.py: DIR/
live.html polls DIR/live.json, rewritten at every keyframe) from an HTTP
server on 127.0.0.1:--live-port (0 = ephemeral).

Not ported: the compile prewarm of the JAX app (the port compiles
nothing).

Usage: python -m rgbd360_torch.apps.sphere_graph_slam <dataset_dir>
       [--first 1] [--sample 1] [--out DIR] [--calib-root DIR] [--lc-thread]
       [--live-view DIR] [--live-port P] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from rgbd360_torch.apps.common import default_matcher_config, load_calib, rot_offset, sequence_frames
from rgbd360_torch.config import default_params
from rgbd360_torch.core.graph_optimizer import GraphOptimizer
from rgbd360_torch.core.loop_closure import LoopClosure360
from rgbd360_torch.core.map360 import Map360
from rgbd360_torch.core.matcher import PLANAR_ODOMETRY_3DOF
from rgbd360_torch.core.plane_extraction import planes_pipeline
from rgbd360_torch.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP
from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360
from rgbd360_torch.core.relocalizer import Relocalizer360
from rgbd360_torch.core.topological import TopologicalMap360
from rgbd360_torch.utils.live_viewer import LiveMapViewer
from rgbd360_torch.utils.map_html import map_to_html
from rgbd360_torch.utils.timing import span, stage
from rgbd360_torch.utils.viz import save_trajectory

TRACK_BACK_KFS = 5  # reference SphereGraphSLAM.cpp:175-180
PARTITION_EVERY = 4  # reference KFsphere_SLAM.cpp:710


def run(argv=None) -> SimpleNamespace:
    """The app: parse ``argv``, run the SLAM loop over the dataset, write
    --out. Returns the session (world, optimizer, topo, loop_closer,
    n_loop_closures) for callers that inspect the map afterwards."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset")
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--sample", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames, the map and the aligners")
    ap.add_argument("--lc-thread", action="store_true",
                    help="run loop closure on a background thread (reference"
                         " behavior); default is synchronous/deterministic")
    ap.add_argument("--live-view", default=None, metavar="DIR",
                    help="serve a live map viewer (reference Map360_Visualizer"
                         " analogue): writes DIR/live.html + live.json and an"
                         " HTTP server; open the printed URL in a browser")
    ap.add_argument("--live-port", type=int, default=0, help="live viewer port (0 = ephemeral)")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    cfg = default_matcher_config(args.calib_root)
    registerer = RegisterRGBD360(cfg)
    aligner = RegisterPhotoICP(n_pyr_levels=5, device=args.device)
    off = rot_offset()

    world = Map360()
    topo = TopologicalMap360(world)
    # robust=True: Huber-weighted pose-graph LM — guards against false-
    # positive loop closures the avDepthResidual<2.0 accept gate lets through
    optimizer = GraphOptimizer(robust=True)
    loop_closer = LoopClosure360(world, optimizer, cfg, device=args.device)
    if args.lc_thread:
        loop_closer.start()

    current_pose = np.eye(4, dtype=np.float64)
    n_lc = 0
    viewer = None
    if args.live_view:
        viewer = LiveMapViewer(args.live_view, port=args.live_port, title="SphereGraphSLAM live")
        print(f"live viewer: {viewer.url or args.live_view}")
    t_last = time.perf_counter()
    frames = sequence_frames(calib, args.dataset, args.first, args.sample, args.device, defer_device=True)
    for frame_no, frame in planes_pipeline(frames):
        # the frame's spans and stages nest under one span that names it
        with span("frame", frame=frame_no):
            if len(world) == 0:
                world.add_keyframe(frame, current_pose)
                world.optimized_poses.append(current_pose.astype(np.float32))
                topo.add_keyframe(world.current_area)
                optimizer.add_vertex(current_pose)
                print(f"frame {frame_no}: first keyframe ({(time.perf_counter() - t_last) * 1000.0:.3f} ms)")
                t_last = time.perf_counter()
                continue

            # track against up to 5 most recent keyframes (:175-180)
            tracked = False
            line = ""
            for back in range(1, min(TRACK_BACK_KFS, len(world)) + 1):
                ref_id = len(world) - back
                with stage("PbMap registration"):
                    ok = registerer.register_pbmap(world.frames[ref_id], frame, 25, PLANAR_ODOMETRY_3DOF)
                if not ok:
                    continue
                rel_pb = registerer.get_pose().astype(np.float64)
                # dense refinement seeded by the PbMap estimate
                aligner.set_target_frame(world.frames[ref_id].sphere_rgb, world.frames[ref_id].sphere_depth_mm)
                aligner.set_source_frame(frame.sphere_rgb, frame.sphere_depth_mm)
                guess = off @ rel_pb @ np.linalg.inv(off)
                aligner.align_frames360(guess.astype(np.float32), PHOTO_DEPTH)
                rel = np.linalg.inv(off) @ aligner.get_optimal_pose().astype(np.float64) @ off
                # a diverged dense refinement must not become a keyframe pose /
                # graph edge (LC accepts avDepthResidual < 2, odometry bounds |t|)
                if (
                    aligner.av_depth_residual >= 2.0
                    or np.linalg.norm(rel[:3, 3]) > default_params.max_translation_odometry
                ):
                    print(f"frame {frame_no}: DISCONTINUOUS dense refinement rejected "
                          f"(avDepth={aligner.av_depth_residual:.3f}, |t|={np.linalg.norm(rel[:3, 3]):.3f})")
                    continue
                info = aligner.get_hessian()
                sso = registerer.get_area_matched() / max(registerer.area_source, 1e-9)

                current_pose = world.trajectory_poses[ref_id].astype(np.float64) @ rel
                kf_id = world.add_keyframe(frame, current_pose)
                world.optimized_poses.append(current_pose.astype(np.float32))
                topo.add_keyframe(world.current_area)
                topo.add_connection(ref_id, kf_id, float(sso))
                world.add_connection(ref_id, kf_id, rel, info)
                optimizer.add_vertex(current_pose)
                optimizer.add_edge(ref_id, kf_id, rel, info)
                line = (f"frame {frame_no}: kf {kf_id} tracked vs {ref_id} "
                        f"|t|={np.linalg.norm(rel[:3, 3]):.3f} avDepth={aligner.av_depth_residual:.3f}")
                tracked = True
                break
            if not tracked:
                # relocalize against the whole map (reference Relocalizer360.h:78,
                # invoked from the tracking-lost path, KFsphere_SLAM.cpp:728+)
                relocalizer = Relocalizer360(world, cfg, device=args.device)
                with stage("Relocalization"):
                    reloc = relocalizer.relocalize(frame)
                if reloc is None:
                    print(f"frame {frame_no}: TRACKING LOST (no PbMap match, no relocalization) "
                          f"({(time.perf_counter() - t_last) * 1000.0:.3f} ms)")
                    t_last = time.perf_counter()
                    continue
                ref_id, rel_pb, rel_info = reloc
                current_pose = world.trajectory_poses[ref_id].astype(np.float64) @ rel_pb.astype(np.float64)
                kf_id = world.add_keyframe(frame, current_pose)
                world.optimized_poses.append(current_pose.astype(np.float32))
                topo.add_keyframe(world.current_area)
                # the SSO entry the tracked path writes: without it the
                # relocalized keyframe is an all-zero affinity row
                reloc_reg = relocalizer.registerer
                sso_reloc = reloc_reg.get_area_matched() / max(reloc_reg.area_source, 1e-9)
                topo.add_connection(ref_id, kf_id, float(sso_reloc))
                optimizer.add_vertex(current_pose)
                # the relocalized vertex must be constrained: an edge-less vertex
                # has an all-zero Hessian block and wrecks the next optimization
                optimizer.add_edge(ref_id, kf_id, rel_pb.astype(np.float64), rel_info.astype(np.float64))
                world.add_connection(ref_id, kf_id, rel_pb, rel_info)
                line = f"frame {frame_no}: kf {kf_id} RELOCALIZED against kf {ref_id}"

            kf_id = len(world) - 1
            if args.lc_thread:
                loop_closer.notify_keyframe(kf_id)
            else:
                with stage("Loop closure"):
                    loop_closer.process_new_keyframe(kf_id)
            # drain the LC handoff (reference :251-271), for both modes, under
            # the map mutex
            drained = 0
            with world.mutex:
                while loop_closer.connections_lc:
                    kf1, conns = loop_closer.connections_lc.popitem()
                    for kf2, sso in conns.items():
                        topo.add_connection(kf1, kf2, float(sso))
                        drained += 1
            if drained:
                n_lc += drained
                with world.mutex, stage("Graph optimization"):
                    optimizer.optimize_graph()
                    world.optimized_poses = [p.astype(np.float32) for p in optimizer.get_poses()]
                line += f"; {drained} loop closure(s), graph optimized"

            if len(world) % PARTITION_EVERY == 0:
                with stage("Partition"):
                    changed = topo.partitioner()
                if changed:
                    line += f"; topology re-partitioned: {len(world.areas)} areas"
            print(f"{line} ({(time.perf_counter() - t_last) * 1000.0:.3f} ms)")
            t_last = time.perf_counter()
            if viewer is not None:
                viewer.update(world)

    if args.lc_thread:
        loop_closer.stop()
    if viewer is not None:
        viewer.update(world)
        viewer.close()
    print(f"map: {len(world)} keyframes, {len(world.areas)} areas, {n_lc} loop closures "
          f"(pairs per refinement {loop_closer.refinements})")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_trajectory(os.path.join(args.out, "trajectory_slam.txt"), world.trajectory_poses)
        if world.optimized_poses:
            save_trajectory(os.path.join(args.out, "trajectory_optimized.txt"), world.optimized_poses)
        optimizer.save_graph(os.path.join(args.out, "pose_graph.g2o"))
        map_to_html(os.path.join(args.out, "map.html"), world, title="SphereGraphSLAM map")
        print(f"artifacts -> {args.out}")
    return SimpleNamespace(world=world, optimizer=optimizer, topo=topo, loop_closer=loop_closer, n_loop_closures=n_lc)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
