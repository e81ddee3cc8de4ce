"""EvalCalibration / EvalPairCalibration — numeric evaluation of an
extrinsic calibration (reference Calibration/EvalCalibration.cpp: builds
frames from a sequence under the given extrinsics and scores them;
EvalPairCalibration.cpp scores a single sensor pair).

Counterpart of rgbd360_tpu/apps/eval_calibration.py; the frames, their
planes and the dense aligns on --device (the card unless named). Two scores
are reported:
  * control-plane consistency: rotation error |n_i - n_j| and plane-offset
    residual of cross-sensor matched planes under the calibration (the
    quantity the Calibrator minimizes, Calibrator.h:871-1180) — per pair
    and overall;
  * dense self-consistency (the reference's ICP-fitness equivalent): when
    two+ frames are given, the avDepthResidual of the dense spherical
    alignment of consecutive frames stitched under the calibration (on the
    card the windowed warp-gather kernels carry its sweeps).

Usage: python -m rgbd360_torch.apps.eval_calibration <dataset_dir>
       [--extrinsics DIR] [--first 1] [--sample 1] [--max-frames 4]
       [--pair S1 S2] [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rgbd360_torch.apps.calibrate_rig import add_sequence_args, frames_with_planes, gather_control_planes
from rgbd360_torch.apps.common import load_calib
from rgbd360_torch.core.calibrator import Calibrator, PlaneCorrespondences


def eval_extrinsics(corresp: PlaneCorrespondences, rt: np.ndarray, pair=None):
    """Per-pair and overall (rotation error^2, translation residual^2) means."""
    rows_of = corresp.rows
    report = {}
    for (i, j), rows in sorted(rows_of.items()):
        if pair is not None and (i, j) != tuple(sorted(pair)):
            continue
        sub = PlaneCorrespondences(rows={(i, j): rows})
        c = Calibrator(sub)
        c.rt = rt
        n = len(rows)
        report[(i, j)] = (
            c.rotation_error2() / n,
            c.translation_error2() / n,
            n,
        )
    total_n = sum(n for _, _, n in report.values()) or 1
    overall = (
        sum(r * n for r, _, n in report.values()) / total_n,
        sum(t * n for _, t, n in report.values()) / total_n,
    )
    return report, overall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_sequence_args(ap, max_frames=4)
    ap.add_argument("--extrinsics", default=None,
                    help="directory of Rt_0*.txt files (default: the calibration root's)")
    ap.add_argument("--pair", type=int, nargs=2, default=None,
                    help="evaluate one sensor pair only (EvalPairCalibration)")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    if args.extrinsics:
        calib.load_extrinsic_calibration(args.extrinsics)
    rt = calib.Rt.astype(np.float64)

    corresp = PlaneCorrespondences()
    frames = []
    for frame_no, frame in frames_with_planes(calib, args):
        added = gather_control_planes(frame, corresp, rt)
        frames.append(frame)
        print(f"frame {frame_no}: {added} control-plane pairs")

    report, overall = eval_extrinsics(corresp, rt, args.pair)
    for (i, j), (rot2, trans2, cnt) in report.items():
        print(f"pair {i}-{j}: n={cnt:3d}  rotMSE={rot2:.6f}  transMSE={trans2:.6f}")
    print(f"overall: rotMSE={overall[0]:.6f}  transMSE={overall[1]:.6f}")

    if len(frames) >= 2 and args.pair is None:
        from rgbd360_torch.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP

        aligner = RegisterPhotoICP(n_pyr_levels=5, device=args.device)
        residuals = []
        for a, b in zip(frames[:-1], frames[1:]):
            aligner.set_target_frame(a.sphere_rgb, a.sphere_depth_mm)
            aligner.set_source_frame(b.sphere_rgb, b.sphere_depth_mm)
            aligner.align_frames360(np.eye(4, dtype=np.float32), PHOTO_DEPTH)
            residuals.append(aligner.av_depth_residual)
        print(f"avScoreFitness (mean avDepthResidual over {len(residuals)} "
              f"consecutive alignments): {np.mean(residuals):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
