"""OnlineOdometryRGBD360 — live odometry fed by a grabber source
(reference Registration/OnlineOdometryRGBD360.cpp:72-386, disabled in the
reference build: grabs 8-sensor frames from the rig and runs the dense
odometry loop on them as they arrive).

Counterpart of rgbd360_tpu/apps/online_odometry.py. The source is a
Grabber (io/grabber.py): replay of a recorded dataset or the synthetic
generator, since there is no camera hardware. Per frame: Frame360.set_raw,
undistort, stitch, then the facade's Photo+Depth align (5 levels) against
the previous frame, seeded by the previous relative pose; poses chained in
the cloud frame. Unlike apps/odometry.py there is no max_translation_
odometry rejection, as in the JAX app. Runs on the card unless --device
names another device.

Usage: python -m rgbd360_torch.apps.online_odometry [--dataset DIR |
       --synthetic N] [--first 1] [--out DIR] [--calib-root DIR]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from rgbd360_torch.apps.common import load_calib, rot_offset
from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP
from rgbd360_torch.io.grabber import ReplaySource, SyntheticSource
from rgbd360_torch.utils.viz import save_trajectory


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames and the aligner")
    args = ap.parse_args(argv)

    if args.dataset:
        source = ReplaySource(args.dataset, first=args.first)
    elif args.synthetic:
        source = SyntheticSource(num_frames=args.synthetic)
    else:
        ap.error("one of --dataset / --synthetic is required")

    calib = load_calib(args.calib_root)
    aligner = RegisterPhotoICP(n_pyr_levels=5, device=args.device)
    off = rot_offset()

    current_pose = np.eye(4, dtype=np.float64)
    trajectory = [current_pose.copy()]
    prev = None
    seed = np.eye(4, dtype=np.float64)
    n = 0

    for raw in source:
        t0 = time.time()
        frame = Frame360(calib, n, args.device)
        frame.set_raw(raw)
        frame.undistort()
        frame.stitch_spherical_image()
        if prev is not None:
            aligner.set_target_frame(prev.sphere_rgb, prev.sphere_depth_mm)
            aligner.set_source_frame(frame.sphere_rgb, frame.sphere_depth_mm)
            aligner.align_frames360(seed.astype(np.float32), PHOTO_DEPTH)
            rel_sphere = aligner.get_optimal_pose().astype(np.float64)
            rel = np.linalg.inv(off) @ rel_sphere @ off
            seed = rel_sphere
            current_pose = current_pose @ rel
            trajectory.append(current_pose.copy())
            print(f"frame {n}: |t|={np.linalg.norm(rel[:3,3]):.4f} "
                  f"avDepth={aligner.av_depth_residual:.3f} ({time.time()-t0:.2f}s)")
        else:
            print(f"frame {n}: reference")
        prev = frame
        n += 1

    source.close()
    print(f"{n} frames, trajectory length "
          f"{sum(np.linalg.norm(b[:3,3]-a[:3,3]) for a, b in zip(trajectory, trajectory[1:])):.3f} m")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_trajectory(os.path.join(args.out, "trajectory_online.txt"), trajectory)
    return 0


if __name__ == "__main__":
    sys.exit(main())
