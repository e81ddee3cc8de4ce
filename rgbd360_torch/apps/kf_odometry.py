"""OdometryKeyFrame360 — keyframe-based odometry
(reference Registration/OdometryKeyFrame360.cpp:75-311): track every frame
against the last keyframe; promote a new keyframe when the alignment's
avDepthResidual reaches 0.9; reject discontinuous motion (difference between
consecutive relative poses bounded, :75-90).

Counterpart of rgbd360_tpu/apps/kf_odometry.py (the compile prewarm is not
ported). Runs on the card unless --device names another device.

Usage: python -m rgbd360_torch.apps.kf_odometry <dataset_dir> [--first 1]
       [--sample 1] [--out DIR] [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rgbd360_torch.apps.common import load_calib, rot_offset, sequence_frames
from rgbd360_torch.config import default_params
from rgbd360_torch.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP
from rgbd360_torch.utils.viz import save_trajectory

SELECT_KF_RESIDUAL = 0.9  # reference :289
# rotation alternative to the translation-only keyframe gate — a deliberate
# deviation from Miscellaneous.h:66 semantics (see promotion comment below)
MIN_ROT_KEYFRAMES_DEG = 10.0
MAX_DIFF_ROT_DEG = 40.0  # isOdometryContinuousMotion-style gates (:75-90)
MAX_DIFF_TRANS = 0.4


def is_continuous(rel_prev: np.ndarray, rel: np.ndarray) -> bool:
    dt = np.linalg.norm(rel[:3, 3] - rel_prev[:3, 3])
    if dt > MAX_DIFF_TRANS:
        return False
    rrel = rel_prev[:3, :3].T @ rel[:3, :3]
    ang = np.degrees(np.arccos(np.clip((np.trace(rrel) - 1) / 2, -1, 1)))
    return ang <= MAX_DIFF_ROT_DEG


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset")
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--sample", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames and the aligner")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    aligner = RegisterPhotoICP(n_pyr_levels=5, device=args.device)
    off = rot_offset()

    keyframe = None
    kf_pose = np.eye(4, dtype=np.float64)
    rel_prev = np.eye(4, dtype=np.float64)
    trajectory = []
    kf_count = 0

    for frame_no, frame in sequence_frames(calib, args.dataset, args.first, args.sample, args.device):
        if keyframe is None:
            keyframe = frame
            trajectory.append(kf_pose.copy())
            kf_count += 1
            print(f"frame {frame_no}: first keyframe")
            continue

        aligner.set_target_frame(keyframe.sphere_rgb, keyframe.sphere_depth_mm)
        aligner.set_source_frame(frame.sphere_rgb, frame.sphere_depth_mm)
        aligner.align_frames360(rel_prev.astype(np.float32), PHOTO_DEPTH)
        rel = aligner.get_optimal_pose().astype(np.float64)
        if not is_continuous(rel_prev, rel):
            # discontinuous motion is a registration failure (reference
            # :75-90, fallback :244-252): hold the last good pose, keep the
            # previous seed
            trajectory.append((kf_pose @ np.linalg.inv(off) @ rel_prev @ off).copy())
            print(f"frame {frame_no}: DISCONTINUOUS motion rejected (avDepth={aligner.av_depth_residual:.3f})")
            continue
        rel_cloud = np.linalg.inv(off) @ rel @ off
        current = kf_pose @ rel_cloud
        trajectory.append(current.copy())

        # keyframe promotion: avDepthResidual >= 0.9 (reference :289), plus a
        # minimum-motion gate — translation (min_dist_keyframes,
        # Miscellaneous.h:66) OR rotation, a deliberate deviation of the JAX
        # app from the reference's translation-only gate, which deadlocked
        # in-place rotation against a stale keyframe
        rot_deg = np.degrees(np.arccos(np.clip((np.trace(rel_cloud[:3, :3]) - 1) / 2, -1, 1)))
        moved = (
            np.linalg.norm(rel_cloud[:3, 3]) > default_params.min_dist_keyframes
            or rot_deg > MIN_ROT_KEYFRAMES_DEG
        )
        promote = aligner.av_depth_residual >= SELECT_KF_RESIDUAL and moved
        print(f"frame {frame_no}: avDepth={aligner.av_depth_residual:.3f} "
              f"|t|={np.linalg.norm(rel_cloud[:3, 3]):.3f}" + ("  -> new keyframe" if promote else ""))
        if promote:
            keyframe = frame
            kf_pose = current
            rel_prev = np.eye(4)
            kf_count += 1
        else:
            rel_prev = rel

    print(f"{kf_count} keyframes, {len(trajectory)} poses")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_trajectory(os.path.join(args.out, "trajectory_kf.txt"), trajectory)
    return 0


if __name__ == "__main__":
    sys.exit(main())
