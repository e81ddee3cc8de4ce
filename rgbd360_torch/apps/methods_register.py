"""MethodsRegisterRGBD360 — compare the registration methods on one pair
(reference Registration/MethodsRegisterRGBD360.cpp): plane-based PbMap,
dense spherical Photo+Depth (plain and occlusion-aware), projective
point-to-plane ICP, and the 8-camera robot-frame dense variant — all poses
reported in the cloud frame for direct comparison.

Counterpart of rgbd360_tpu/apps/methods_register.py. Runs on the card
unless --device names another device. Each method's time is synchronised:
every method ends in a host read of its pose. ``methods`` lists the methods
in the app's order, so that a caller can run (and count) them one by one.

Usage: python -m rgbd360_torch.apps.methods_register <a.bin> <b.bin>
       [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from rgbd360_torch.apps.common import default_matcher_config, load_calib, rot_offset
from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.core.matcher import PLANAR_3DOF
from rgbd360_torch.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP
from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360
from rgbd360_torch.ops.icp import icp_point_to_plane_sphere


def methods(f1, f2, matcher_config: Optional[str]) -> List[Tuple[str, Callable[[], Optional[np.ndarray]]]]:
    """(name, method) in the app's order; a method registers frame 2 onto
    frame 1 and returns the cloud-frame pose (4x4 f64 numpy), or None when
    it fails. The frames carry their planes; the dense aligner's pyramids
    are built here, outside the methods."""
    off = rot_offset()
    off_inv = np.linalg.inv(off)
    reg = RegisterRGBD360(matcher_config)
    aligner = RegisterPhotoICP(n_pyr_levels=5, device=f1.device)
    aligner.set_target_frame(f1.sphere_rgb, f1.sphere_depth_mm)
    aligner.set_source_frame(f2.sphere_rgb, f2.sphere_depth_mm)

    def pbmap():
        ok = reg.register_pbmap(f1, f2, 25, PLANAR_3DOF)
        return reg.get_pose().astype(np.float64) if ok else None

    def dense(occlusion):
        aligner.align_frames360(np.eye(4, dtype=np.float32), PHOTO_DEPTH, occlusion=occlusion)
        return off_inv @ aligner.get_optimal_pose().astype(np.float64) @ off

    def icp():
        res = icp_point_to_plane_sphere(
            f2.sphere_depth_mm.to(torch.float32) * 1e-3, f1.sphere_depth_mm.to(torch.float32) * 1e-3,
            torch.eye(4, device=f1.device),
        )
        return off_inv @ res.pose.cpu().numpy().astype(np.float64) @ off

    def dense_8_camera():
        ok = reg.register_dense_photoicp(f1, f2, method=PHOTO_DEPTH, n_levels=4)
        return reg.get_pose().astype(np.float64) if ok else None

    return [
        ("PbMap (PLANAR_3DoF)", pbmap),
        ("Dense Photo+Depth", lambda: dense(0)),
        ("Dense Photo+Depth Occ1", lambda: dense(1)),
        ("Point-to-plane ICP", icp),
        ("Dense 8-camera (robot)", dense_8_camera),
    ]


def run(argv=None) -> dict:
    """The app: parse ``argv``, run every method, print one line each and
    the agreement summary. Returns {name: (pose or None, ms)}."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("frame1")
    ap.add_argument("frame2")
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames and the aligners")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    f1 = Frame360(calib, 0, args.device).build(args.frame1)
    f2 = Frame360(calib, 1, args.device).build(args.frame2)
    f1.get_planes()
    f2.get_planes()
    results = {}
    for name, method in methods(f1, f2, default_matcher_config(args.calib_root)):
        t0 = time.perf_counter()
        pose = method()
        ms = (time.perf_counter() - t0) * 1000.0
        results[name] = (pose, ms)
        if pose is None:
            print(f"{name}: failed ({ms:.3f} ms)")
            continue
        t = pose[:3, 3]
        print(f"{name:26s} t = {np.round(t, 4)}  |t| = {np.linalg.norm(t):.4f}  ({ms:.3f} ms)")

    ts = np.stack([pose[:3, 3] for pose, _ms in results.values() if pose is not None])
    spread = np.linalg.norm(ts - ts.mean(axis=0), axis=1).max()
    print(f"\nmax deviation from mean translation: {spread:.4f} m over {len(ts)} methods")
    return results


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
