"""VisualizeCalibration — render the stitched panorama and cross-sensor seam
diagnostics under a given extrinsic calibration (reference
Calibration/VisualizeCalibration.cpp shows the fused cloud in a PCL viewer;
the headless equivalent dumps the panorama, the depth panorama, the fused
cloud and per-seam depth-step statistics — a bad calibration shows up as
depth steps at the 8 sensor joints).

Counterpart of rgbd360_tpu/apps/visualize_calibration.py; the frame and its
rig-frame cloud are built on --device (the card unless named).

Usage: python -m rgbd360_torch.apps.visualize_calibration <frame.bin>
       [--extrinsics DIR] --out DIR [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rgbd360_torch.apps.common import load_calib
from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.utils.viz import depth_to_u8, host_array, save_png, save_ply


def seam_stats(depth_mm: np.ndarray, num_sensors: int = 8):
    """Depth discontinuity across each sensor joint column: median |step| in
    metres over rows where both sides are valid."""
    h, w = depth_mm.shape
    ws = w // num_sensors
    stats = []
    for s in range(1, num_sensors + 1):
        c = (s * ws) % w
        left = depth_mm[:, c - 1].astype(np.float64)
        right = depth_mm[:, c % w].astype(np.float64)
        ok = (left > 0) & (right > 0)
        step = np.abs(left[ok] - right[ok]) * 0.001
        stats.append(float(np.median(step)) if len(step) else float("nan"))
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("frame")
    ap.add_argument("--extrinsics", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frame")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    if args.extrinsics:
        calib.load_extrinsic_calibration(args.extrinsics)
    frame = Frame360(calib, 0, args.device).build(args.frame)

    os.makedirs(args.out, exist_ok=True)
    rgb = host_array(frame.sphere_rgb)[..., ::-1]  # BGR -> RGB
    depth = host_array(frame.sphere_depth_mm)
    save_png(os.path.join(args.out, "panorama_rgb.png"), rgb)
    save_png(os.path.join(args.out, "panorama_depth.png"), depth_to_u8(depth))

    stats = seam_stats(depth)
    for s, v in enumerate(stats):
        print(f"seam {s}->{(s+1)%8}: median depth step {v:.3f} m")
    print(f"mean seam step: {np.nanmean(stats):.3f} m")

    xyz, rgb_pts = frame.build_sphere_cloud()
    keep = np.isfinite(xyz).all(axis=-1) & (np.abs(xyz) < 20).all(axis=-1)
    save_ply(os.path.join(args.out, "fused_cloud.ply"), xyz[keep], rgb_pts[keep])
    print(f"artifacts -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
