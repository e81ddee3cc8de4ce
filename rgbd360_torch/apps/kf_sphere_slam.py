"""KFsphere_SLAM — keyframe-selection SLAM over a sphere sequence
(reference SLAM/KFsphere_SLAM.cpp:60-793): strong-PbMap frame skipping,
dense avDepthResidual>=0.9 keyframe criterion, nearby-keyframe (<2.5 m)
connection scan with dual dense+PbMap edges, pose-graph optimization on new
loop closures, spectral partitioning every 4 keyframes.

Counterpart of rgbd360_tpu/apps/kf_sphere_slam.py. Frames come through
planes_pipeline over deferred frames, and its pre_collect hook dispatches
the speculative tracking align (KFSphereSLAM.prefetch_align) before each
frame's planes are collected; --no-speculative-align turns it off. The run
ends with the speculative aligns dispatched, consumed and wasted. --resume
continues a map saved with --save-map (core/map_io.py). Runs on the card
unless --device names another device; each frame's line ends with its wall
time (the loop iteration, the next frame's pipeline work included).

Not ported: --live-view (the periphery slice; --out writes map.html) and
the compile prewarm of the JAX app.

Usage: python -m rgbd360_torch.apps.kf_sphere_slam <dataset_dir>
       [--first 1] [--sample 1] [--out DIR] [--calib-root DIR]
       [--save-map DIR] [--resume DIR] [--no-speculative-align]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from rgbd360_torch.apps.common import default_matcher_config, load_calib, sequence_frames
from rgbd360_torch.core.kf_slam import KFSphereSLAM
from rgbd360_torch.core.map_io import load_map_full, save_map
from rgbd360_torch.core.plane_extraction import planes_pipeline
from rgbd360_torch.utils.map_html import map_to_html
from rgbd360_torch.utils.viz import save_trajectory


def run(argv=None) -> KFSphereSLAM:
    """The app: parse ``argv``, run the tracker over the dataset, write
    --out / --save-map. Returns the tracker."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset")
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--sample", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames, the map and the aligner")
    ap.add_argument("--save-map", default=None, help="checkpoint the map (keyframes + state) to this dir")
    ap.add_argument("--resume", default=None, help="resume from a map saved with --save-map")
    ap.add_argument("--no-speculative-align", action="store_true",
                    help="do not dispatch the tracking align before the frame's planes are collected")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    world = optimizer = topo = None
    if args.resume:
        world, optimizer, topo = load_map_full(args.resume, calib, args.device)
        print(f"resumed map: {len(world)} keyframes from {args.resume}")
    slam = KFSphereSLAM(
        world=world, optimizer=optimizer, topo=topo,
        matcher_config=default_matcher_config(args.calib_root),
        speculative_align=not args.no_speculative_align, device=args.device,
    )

    n_frames = 0
    t_last = time.perf_counter()
    frames = sequence_frames(calib, args.dataset, args.first, args.sample, args.device, defer_device=True)
    for frame_no, frame in planes_pipeline(frames, pre_collect=slam.prefetch_align):
        status = slam.process_frame(frame)
        n_frames += 1
        print(f"frame {frame_no}: {status}  (kf={slam.n_keyframes_selected}, lc={slam.n_loop_closures}, "
              f"nearest={slam.nearest_kf}) ({(time.perf_counter() - t_last) * 1000.0:.3f} ms)")
        t_last = time.perf_counter()

    world = slam.world
    spec = slam.speculative_counts
    print(f"{n_frames} frames -> {len(world)} keyframes, {len(world.areas)} areas, "
          f"{slam.n_loop_closures} extra connections; speculative aligns: dispatched {spec['dispatched']} "
          f"consumed {spec['consumed']} wasted {spec['wasted']}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_trajectory(os.path.join(args.out, "trajectory_kf_slam.txt"), world.trajectory_poses)
        if world.optimized_poses:
            save_trajectory(os.path.join(args.out, "trajectory_optimized.txt"), world.optimized_poses)
        slam.optimizer.save_graph(os.path.join(args.out, "pose_graph.g2o"))
        map_to_html(os.path.join(args.out, "map.html"), world, title="KF-SLAM map")
        print(f"artifacts -> {args.out}")
    if args.save_map:
        save_map(slam.world, args.save_map, slam.optimizer, topo=slam.topo)
        print(f"map checkpoint -> {args.save_map}")
    return slam


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
