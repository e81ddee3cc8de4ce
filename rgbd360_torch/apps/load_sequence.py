"""LoadSequence — walk a spherical sequence, register consecutive frames and
export the merged, voxel-filtered global cloud plus per-frame panoramas
(reference Visualization/LoadSequence.cpp, interactive viewer replaced by
artifact export).

Counterpart of rgbd360_tpu/apps/load_sequence.py: frames and the dense
aligner on --device (the card unless named), the clouds and the voxel
filter on the host.

Usage: python -m rgbd360_torch.apps.load_sequence <dataset_dir> --out DIR
       [--first 1] [--sample 1] [--voxel 0.05] [--max-frames N]
       [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rgbd360_torch.apps.common import load_calib, rot_offset, sequence_frames
from rgbd360_torch.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP
from rgbd360_torch.ops.filter_cloud import filter_voxel
from rgbd360_torch.utils.viz import save_ply, save_sphere_images


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset")
    ap.add_argument("--out", required=True)
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--sample", type=int, default=1)
    ap.add_argument("--voxel", type=float, default=0.05)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames and the aligner")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    aligner = RegisterPhotoICP(n_pyr_levels=5, device=args.device)
    off = rot_offset()
    os.makedirs(args.out, exist_ok=True)

    pose = np.eye(4, dtype=np.float64)
    prev = None
    clouds, colors = [], []
    count = 0
    for frame_no, frame in sequence_frames(calib, args.dataset, args.first, args.sample, args.device):
        save_sphere_images(frame, args.out, f"{frame_no:04d}")
        if prev is not None:
            aligner.set_target_frame(prev.sphere_rgb, prev.sphere_depth_mm)
            aligner.set_source_frame(frame.sphere_rgb, frame.sphere_depth_mm)
            aligner.align_frames360(np.eye(4, dtype=np.float32), PHOTO_DEPTH)
            rel = aligner.get_optimal_pose().astype(np.float64)
            pose = pose @ (np.linalg.inv(off) @ rel @ off)
            print(f"frame {frame_no}: |t|={np.linalg.norm(rel[:3,3]):.4f} "
                  f"avDepth={aligner.av_depth_residual:.3f}")
        else:
            print(f"frame {frame_no}: reference")
        xyz, rgb = frame.build_sphere_cloud()  # rig/cloud frame
        keep = np.isfinite(xyz).all(axis=1)
        clouds.append(xyz[keep] @ pose[:3, :3].T + pose[:3, 3])
        colors.append(np.asarray(rgb)[keep])
        prev = frame
        count += 1
        if args.max_frames and count >= args.max_frames:
            break

    xyz = np.concatenate(clouds)
    rgb = np.concatenate(colors)
    xyz_f, rgb_f = filter_voxel(xyz, rgb, leaf=args.voxel)
    save_ply(os.path.join(args.out, "global_map.ply"), xyz_f, rgb_f)
    print(f"{count} frames; global map {len(xyz_f)} voxels -> {args.out}/global_map.ply")
    return 0


if __name__ == "__main__":
    sys.exit(main())
