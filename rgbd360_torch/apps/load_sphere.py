"""LoadSphere / LoadFrame360 — inspect a raw spherical frame and export its
panorama + point cloud (reference Visualization/LoadSphere.cpp and
LoadFrame360.cpp, viewers replaced with artifact dumps).

Counterpart of rgbd360_tpu/apps/load_sphere.py; the frame is built on
--device (the card unless named).

Usage: python -m rgbd360_torch.apps.load_sphere <frame.bin> --out DIR [--planes]
       [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rgbd360_torch.apps.common import load_calib
from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.utils.viz import save_pcd, save_ply, save_sphere_images


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("frame")
    ap.add_argument("--out", required=True)
    ap.add_argument("--planes", action="store_true")
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frame")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    frame = Frame360(calib, 0, args.device).build(args.frame)
    os.makedirs(args.out, exist_ok=True)
    save_sphere_images(frame, args.out, "sphere")
    xyz, rgb = (t.cpu().numpy() for t in frame.build_sphere_cloud_from_image())
    save_ply(os.path.join(args.out, "sphereCloud.ply"), xyz, rgb)
    save_pcd(os.path.join(args.out, "sphereCloud_0.pcd"), xyz, rgb)
    print(f"panorama {tuple(frame.sphere_rgb.shape)}, cloud with "
          f"{int(np.isfinite(xyz[..., 0]).sum())} valid points -> {args.out}")
    if args.planes:
        pbmap = frame.get_planes()
        print(f"{len(pbmap)} planes, total area {frame.get_planar_area():.2f} m^2")
        for p in pbmap.planes:
            print(f"  plane {p.id}: area {p.area_hull:.2f} n {np.round(p.normal,3)} d {p.d:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
