"""LoadFrame360_stereo — load and inspect a stereo-device spherical frame
(reference Visualization/LoadFrame360_stereo.cpp: loads a PNG panorama + raw
float depth, builds the sphere cloud and shows it; here the headless
artifact dumps replace the PCL viewer, utils/viz.py).

Counterpart of rgbd360_tpu/apps/load_stereo.py; the frame, its cloud and
getPlanesStereo's device program on --device (the card unless named).

Usage: python -m rgbd360_torch.apps.load_stereo <rgb.png> <depth.bin> --out DIR
       [--planes] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rgbd360_torch.core.frame360_stereo import Frame360Stereo
from rgbd360_torch.utils.viz import depth_to_u8, host_array, save_pcd, save_png


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("rgb_png")
    ap.add_argument("depth_bin")
    ap.add_argument("--out", required=True)
    ap.add_argument(
        "--planes",
        action="store_true",
        help="run getPlanesStereo segmentation and print the plane table",
    )
    ap.add_argument("--device", default="cuda", help="torch device of the frame")
    args = ap.parse_args(argv)

    frame = Frame360Stereo(device=args.device).build_stereo(args.rgb_png, args.depth_bin)
    os.makedirs(args.out, exist_ok=True)

    rgb = host_array(frame.sphere_rgb)[..., ::-1]
    depth_mm = host_array(frame.sphere_depth_mm)
    save_png(os.path.join(args.out, "stereo_rgb.png"), rgb)
    save_png(os.path.join(args.out, "stereo_depth.png"), depth_to_u8(depth_mm))

    # the stereo variant's OWN backprojection (Frame360_stereo.h:454-517
    # start_phi convention), not the Frame360 panorama one
    xyz, rgb_pts = frame.build_sphere_cloud()
    keep = np.isfinite(xyz).all(axis=-1)
    save_pcd(os.path.join(args.out, "stereo_cloud.pcd"), xyz[keep], rgb_pts[keep])

    valid = depth_mm > 0
    print(f"panorama {rgb.shape[1]}x{rgb.shape[0]}  depth coverage "
          f"{valid.mean():.3f}  range [{depth_mm[valid].min()/1000:.2f}, "
          f"{depth_mm[valid].max()/1000:.2f}] m" if valid.any() else "empty depth")
    if args.planes:
        pbmap = frame.get_planes_stereo()
        print(f"planes: {len(pbmap.planes)}")
        for p in pbmap.planes:
            print(
                f"  plane {p.id}: n=({p.normal[0]:+.2f},{p.normal[1]:+.2f},"
                f"{p.normal[2]:+.2f}) d={p.d:+.2f} pts={p.n_pts} "
                f"area={p.area_hull:.2f}"
            )
    print(f"artifacts -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
