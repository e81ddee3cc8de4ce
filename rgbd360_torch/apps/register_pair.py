"""RegisterPairRGBD360 — align two spherical .bin frames
(reference Registration/RegisterPairRGBD360.cpp:56-171): PbMap match, then
dense Photo+ICP refinement, artifact dumps instead of the PCL viewer.

Counterpart of rgbd360_tpu/apps/register_pair.py. Runs on the card unless
--device names another device.

Usage: python -m rgbd360_torch.apps.register_pair <a.bin> <b.bin>
       [--out DIR] [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rgbd360_torch.apps.common import default_matcher_config, load_calib, rot_offset
from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.core.matcher import PLANAR_3DOF
from rgbd360_torch.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP
from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360
from rgbd360_torch.utils.viz import save_ply, save_sphere_images


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("frame1")
    ap.add_argument("frame2")
    ap.add_argument("--out", default=None, help="artifact output dir")
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames and the aligner")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    f1 = Frame360(calib, 0, args.device).build(args.frame1)
    f2 = Frame360(calib, 1, args.device).build(args.frame2)
    f1.get_planes()
    f2.get_planes()
    print(f"planes: {len(f1.planes)} / {len(f2.planes)}")

    registerer = RegisterRGBD360(default_matcher_config(args.calib_root))
    ok = registerer.register_pbmap(f1, f2, 25, PLANAR_3DOF)
    np.set_printoptions(suppress=True, precision=5)
    if ok:
        print(f"PbMap matches: {registerer.get_matched_planes()} area {registerer.get_area_matched():.2f}")
        print("PbMap pose:\n", registerer.get_pose())
    else:
        print("PbMap registration failed; dense alignment from identity")

    aligner = RegisterPhotoICP(n_pyr_levels=5, device=args.device)
    aligner.set_target_frame(f1.sphere_rgb, f1.sphere_depth_mm)
    aligner.set_source_frame(f2.sphere_rgb, f2.sphere_depth_mm)
    off = rot_offset()
    guess = (off @ registerer.get_pose().astype(np.float64) @ np.linalg.inv(off)) if ok else np.eye(4)
    aligner.align_frames360(guess.astype(np.float32), PHOTO_DEPTH)
    pose_cloud = np.linalg.inv(off) @ aligner.get_optimal_pose().astype(np.float64) @ off
    print("Dense pose (cloud frame):\n", pose_cloud)
    print(f"residuals photo {aligner.av_photo_residual:.4f} depth {aligner.av_depth_residual:.4f} "
          f"SSO {aligner.sso:.4f} entropy {aligner.calc_entropy():.2f}")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_sphere_images(f1, args.out, "frame1")
        save_sphere_images(f2, args.out, "frame2")
        xyz1, rgb1 = (t.cpu().numpy() for t in f1.build_sphere_cloud_from_image())
        xyz2, rgb2 = (t.cpu().numpy() for t in f2.build_sphere_cloud_from_image())
        # the from-image cloud lives in the sphere frame: use the sphere pose
        ps = aligner.get_optimal_pose().astype(np.float64)
        xyz2 = xyz2.reshape(-1, 3) @ ps[:3, :3].T + ps[:3, 3]
        save_ply(os.path.join(args.out, "pair_registered.ply"),
                 np.concatenate([xyz1.reshape(-1, 3), xyz2]),
                 np.concatenate([rgb1.reshape(-1, 3), rgb2.reshape(-1, 3)]))
        print(f"artifacts in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
