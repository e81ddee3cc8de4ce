"""PairCalibrator / OnlinePairCalibrator — extrinsic calibration of ONE
sensor pair from control planes (reference Calibration/PairCalibrator.cpp,
OnlinePairCalibrator.cpp: accumulate plane correspondences for a chosen pair
and solve the decoupled closed-form rotation + LS translation, reporting
conditioning and convergence as data arrives).

Counterpart of rgbd360_tpu/apps/pair_calibrator.py. Offline mode consumes a
saved control-planes file (get_control_planes of either package); online
mode streams a sphere sequence, its frames and planes on --device (the card
unless named), recalibrating after every frame.

Usage:
  python -m rgbd360_torch.apps.pair_calibrator --planes control_planes.npz --pair 0 1
  python -m rgbd360_torch.apps.pair_calibrator --dataset DIR --pair 0 1 [--max-frames 8]
         [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rgbd360_torch.apps.common import load_calib, sequence_files
from rgbd360_torch.core.calibrator import PairCalibrator, PlaneCorrespondences


def calibrate_pair_from(corresp: PlaneCorrespondences, s1: int, s2: int, init_rt):
    pc = PairCalibrator()
    pc.correspondences = corresp.matrix(s1, s2)
    pc.set_init_rt(init_rt)
    est = pc.calibrate_pair()
    return pc, est


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--planes", default=None, help="control_planes.npz from get_control_planes")
    ap.add_argument("--dataset", default=None, help="sphere sequence for online mode")
    ap.add_argument("--pair", type=int, nargs=2, required=True)
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--sample", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=8)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--out", default=None, help="write the estimated Rt here")
    ap.add_argument("--device", default="cuda", help="torch device of the frames (online mode)")
    args = ap.parse_args(argv)
    s1, s2 = sorted(args.pair)

    calib = load_calib(args.calib_root)
    init = np.linalg.inv(calib.Rt[s1].astype(np.float64)) @ calib.Rt[s2].astype(np.float64)

    if args.planes:
        from rgbd360_torch.apps.get_control_planes import load_correspondences

        corresp = load_correspondences(args.planes)
        pc, est = calibrate_pair_from(corresp, s1, s2, init)
        n = len(corresp.rows.get((s1, s2), []))
        print(f"pair {s1}-{s2}: {n} correspondences, "
              f"conditioning {corresp.conditioning(s1, s2):.1f}")
    elif args.dataset:
        from rgbd360_torch.apps.calibrate_rig import gather_control_planes
        from rgbd360_torch.core.frame360 import Frame360

        corresp = PlaneCorrespondences()
        est = None
        pc = None
        count = 0
        for frame_no, path in sequence_files(args.dataset, args.first, args.sample):
            frame = Frame360(calib, frame_no, args.device).build(path)
            frame.get_planes()
            gather_control_planes(frame, corresp, calib.Rt.astype(np.float64))
            n = len(corresp.rows.get((s1, s2), []))
            pc, est = calibrate_pair_from(corresp, s1, s2, init)
            status = "ok" if est is not None else "ill-conditioned"
            print(f"frame {frame_no}: {n} correspondences for pair {s1}-{s2} -> {status}")
            count += 1
            if count >= args.max_frames:
                break
    else:
        ap.error("one of --planes / --dataset is required")

    if est is None:
        print("calibration not recoverable (conditioning gate)")
        return 1
    diff = est - init
    print(f"Rt estimate for sensor {s2} wrt {s1} "
          f"(|dR|={np.abs(diff[:3,:3]).max():.5f}, |dt|={np.linalg.norm(diff[:3,3]):.5f} vs init):")
    print(np.array2string(est, precision=6, suppress_small=True))
    if args.out:
        np.savetxt(args.out, est, fmt="%10.6f")
        print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
