"""OdometryRGBD360 — frame-to-frame dense spherical odometry
(reference Registration/OdometryRGBD360.cpp:75-297).

Counterpart of rgbd360_tpu/apps/odometry.py. Per frame, the dense
Photo+Depth alignment (5 pyramid levels) against the previous frame, seeded
with the previous relative pose or, with --with-planes, with the PbMap
registration (PLANAR_3DOF, up to 25 planes) of the two frames' planes
through the 157.5 deg offset; poses chained in the cloud frame; a pair
whose translation exceeds max_translation_odometry is rejected; trajectory
saved. Runs on the card unless --device names another device.

With --with-planes the frames' planes come from planes_pipeline
(core/plane_extraction.py) over raw frames: each frame's device program
(undistort, stitch and plane statistics in one call) is dispatched before
the previous frame's planes are fitted on a worker thread, so the host fit
overlaps the next pair's work. The planes are those of get_planes(
need_inliers=False), which the JAX app calls frame by frame.

Usage: python -m rgbd360_torch.apps.odometry <dataset_dir> [--first 1]
       [--sample 1] [--out DIR] [--calib-root DIR] [--with-planes]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from rgbd360_torch.apps.common import default_matcher_config, load_calib, rot_offset, sequence_frames
from rgbd360_torch.config import default_params
from rgbd360_torch.core.matcher import PLANAR_3DOF
from rgbd360_torch.core.plane_extraction import planes_pipeline
from rgbd360_torch.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP
from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360
from rgbd360_torch.utils.timing import stage
from rgbd360_torch.utils.viz import save_trajectory


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset")
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--sample", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames and the aligner")
    ap.add_argument("--with-planes", action="store_true",
                    help="run PbMap registration to seed the dense aligner")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    registerer = RegisterRGBD360(default_matcher_config(args.calib_root))
    aligner = RegisterPhotoICP(n_pyr_levels=5, device=args.device)
    off = rot_offset()

    current_pose = np.eye(4, dtype=np.float64)
    trajectory = [current_pose.copy()]
    prev = None
    rel_dense = np.eye(4, dtype=np.float64)

    frames = sequence_frames(calib, args.dataset, args.first, args.sample, args.device, defer_device=args.with_planes)
    if args.with_planes:
        frames = planes_pipeline(frames, need_inliers=False)
    for frame_no, frame in frames:
        t0 = time.time()
        if prev is None:
            prev = frame
            print(f"frame {frame_no}: reference")
            continue

        guess = rel_dense
        pbmap_ok = False
        if args.with_planes and prev.planes is not None:
            with stage("PbMap registration"):
                pbmap_ok = registerer.register_pbmap(prev, frame, 25, PLANAR_3DOF)
            if pbmap_ok:
                guess = off @ registerer.get_pose().astype(np.float64) @ np.linalg.inv(off)

        aligner.set_target_frame(prev.sphere_rgb, prev.sphere_depth_mm)
        aligner.set_source_frame(frame.sphere_rgb, frame.sphere_depth_mm)
        aligner.align_frames360(guess.astype(np.float32), PHOTO_DEPTH)
        rel_sphere = aligner.get_optimal_pose().astype(np.float64)
        rel_cloud = np.linalg.inv(off) @ rel_sphere @ off
        rel_dense = rel_sphere  # seed for the next pair (reference :192)

        # odometry motion bound: a per-pair translation beyond
        # max_translation_odometry (reference include/Miscellaneous.h:69) is
        # a registration failure — keep the previous pose and re-seed
        if np.linalg.norm(rel_cloud[:3, 3]) > default_params.max_translation_odometry:
            print(f"frame {frame_no}: REJECTED |t|={np.linalg.norm(rel_cloud[:3,3]):.2f} "
                  f"> max_translation_odometry")
            rel_dense = np.eye(4, dtype=np.float64)
            prev = frame
            continue

        current_pose = current_pose @ rel_cloud
        trajectory.append(current_pose.copy())
        planes = (f" planes {len(prev.planes)}/{len(frame.planes)} pbmap {'ok' if pbmap_ok else 'no'}"
                  if args.with_planes else "")
        print(
            f"frame {frame_no}: |t|={np.linalg.norm(rel_cloud[:3,3]):.4f} "
            f"avDepth={aligner.av_depth_residual:.3f} SSO={aligner.sso:.3f}{planes} "
            f"({time.time()-t0:.2f}s)"
        )
        prev = frame

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_trajectory(os.path.join(args.out, "trajectory.txt"), trajectory)
        print(f"trajectory ({len(trajectory)} poses) -> {args.out}/trajectory.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
