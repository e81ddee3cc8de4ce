"""LaserCalibrator — extrinsic calibration of a 2D laser scanner against an
RGB-D sensor from plane-line correspondences (reference
Calibration/LaserCalibrator.cpp + include/CalibrateLaser.h:54-826: planes
observed by the RGB-D camera matched with the line segments the laser sees
where its scan plane cuts them; decoupled rotation GN + translation LS).

Correspondence file: one row per observation,
    nx ny nz d  lx ly lz  cx cy cz
(plane normal + offset in camera frame; line direction + a point on the line
in laser frame). With --demo, a synthetic rig validates the solver instead.

A copy of rgbd360_tpu/apps/calibrate_laser.py: host numpy, no device work,
so no --device.

Usage: python -m rgbd360_torch.apps.calibrate_laser (--corresp FILE | --demo)
       [--out FILE]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rgbd360_torch.core.calibrate_laser import CalibPairLaserKinect


def load_correspondences(path: str) -> CalibPairLaserKinect:
    cal = CalibPairLaserKinect()
    for row in np.loadtxt(path, ndmin=2):
        cal.add(row[0:3], float(row[3]), row[4:7], row[7:10])
    return cal


def synthetic_rig(n: int = 24, seed: int = 0) -> tuple:
    """Random planes observed by a camera and cut by a laser at a known
    extrinsic pose; returns (calibrator, true_rt)."""
    rng = np.random.default_rng(seed)
    a = 0.35
    rt = np.eye(4)
    rt[:3, :3] = np.array(
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    )
    rt[:3, 3] = [0.12, -0.05, 0.30]
    cal = CalibPairLaserKinect()
    for _ in range(n):
        nrm = rng.normal(size=3)
        nrm /= np.linalg.norm(nrm)
        d = rng.uniform(1.0, 4.0)
        # laser-frame plane
        n_l = rt[:3, :3].T @ nrm
        d_l = d - float(nrm @ rt[:3, 3])
        # the laser's scan plane is z=0 in its own frame: the cut line
        line_dir = np.cross(n_l, [0.0, 0.0, 1.0])
        if np.linalg.norm(line_dir) < 0.1:
            continue  # plane ~parallel to the scan plane: no cut
        line_dir /= np.linalg.norm(line_dir)
        # a point on the cut: solve n_l.p = d_l with p_z = 0
        p = np.zeros(3)
        k = np.argmax(np.abs(n_l[:2]))
        p[k] = d_l / n_l[k]
        cal.add(nrm, d, line_dir, p)
    return cal, rt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--corresp", default=None)
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.demo:
        cal, truth = synthetic_rig()
    elif args.corresp:
        cal, truth = load_correspondences(args.corresp), None
    else:
        ap.error("one of --corresp / --demo is required")

    rt = cal.calibrate()
    if rt is None:
        print("calibration not recoverable (degenerate correspondences)")
        return 1
    print("laser-from-camera extrinsic estimate:")
    print(np.array2string(rt, precision=6, suppress_small=True))
    if truth is not None:
        print(f"demo ground-truth error: |dR|={np.abs(rt[:3,:3]-truth[:3,:3]).max():.2e} "
              f"|dt|={np.linalg.norm(rt[:3,3]-truth[:3,3]):.2e}")
    if args.out:
        np.savetxt(args.out, rt, fmt="%10.6f")
        print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
