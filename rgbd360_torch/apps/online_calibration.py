"""OnlineCalibration — streaming whole-rig extrinsic calibration
(reference Calibration/OnlineCalibration.cpp: accumulates control planes
from the live 8-sensor stream and re-runs the joint Calibrate() as data
arrives, reporting error/conditioning convergence; here the stream is a
recorded sphere sequence).

Counterpart of rgbd360_tpu/apps/online_calibration.py; the frames and their
planes on --device (the card unless named), the solves on the host.

Usage: python -m rgbd360_torch.apps.online_calibration <dataset_dir>
       [--first 1] [--sample 1] [--max-frames 10] [--out DIR]
       [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rgbd360_torch.apps.calibrate_rig import add_sequence_args, frames_with_planes, gather_control_planes, save_extrinsics
from rgbd360_torch.apps.common import load_calib
from rgbd360_torch.core.calibrator import Calibrator, PlaneCorrespondences


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_sequence_args(ap, max_frames=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    init_rt = calib.Rt.astype(np.float64)
    corresp = PlaneCorrespondences()
    cal = None

    for frame_no, frame in frames_with_planes(calib, args):
        added = gather_control_planes(frame, corresp, init_rt)
        # re-solve with everything seen so far (the reference recalibrates
        # per spin of its online loop)
        cal = Calibrator(corresp)
        cal.calibrate()
        rot_err = cal.rotation_error2()
        trans_err = cal.translation_error2()
        total = sum(len(r) for r in corresp.rows.values())
        print(
            f"frame {frame_no}: +{added} planes (total {total}, "
            f"{len(corresp.rows)} pairs)  rotErr2={rot_err:.5f}  "
            f"transErr2={trans_err:.5f}  cond={cal.conditioning:.1f}"
        )

    if cal is None:
        print("no frames")
        return 1
    if args.out:
        save_extrinsics(cal.rt, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
