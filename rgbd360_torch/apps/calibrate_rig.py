"""Calibrator / GetControlPlanes / EvalCalibration — the extrinsic
calibration tool suite (reference Calibration/Calibrator.cpp,
GetControlPlanes.cpp, EvalCalibration.cpp).

Counterpart of rgbd360_tpu/apps/calibrate_rig.py: each frame is built and
its planes extracted on --device (the card unless named; the plane layer's
device program), the matching and the solve are host float64. Gathers
control planes (planes observed by adjacent sensors, matched in each sensor
pair's overlap), solves the decoupled rotation/translation calibration, and
reports per-pair conditioning and the correspondence residuals
before/after (the EvalCalibration statistics). The stages "Control-plane
gather" and "Calibration solve" are timed when stage timing is on
(utils/timing.py).

Usage: python -m rgbd360_torch.apps.calibrate_rig <dataset_dir> [--first 1]
       [--sample 1] [--max-frames 10] [--out DIR] [--calib-root DIR]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rgbd360_torch.apps.common import load_calib, sequence_files
from rgbd360_torch.core.calibrator import Calibrator, PlaneCorrespondences
from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.utils.timing import stage


def gather_control_planes(frame, corresp: PlaneCorrespondences, init_rt) -> int:
    """Match planes between adjacent sensors (GetControlPlanes): local planes
    are in the rig frame already (plane_extraction transforms them); a plane
    seen by sensors s and s+1 is the same physical surface when normals and
    offsets agree under the current calibration."""
    added = 0
    local = frame.local_planes
    if local is None:
        return 0
    for s in range(8):
        s2 = (s + 1) % 8
        for p1 in local[s]:
            for p2 in local[s2]:
                if p1.normal @ p2.normal > 0.99 and abs(p1.d - p2.d) < 0.1:
                    # store in each sensor's own frame for the calibration
                    rt1, rt2 = init_rt[s], init_rt[s2]
                    n1 = rt1[:3, :3].T @ p1.normal
                    d1 = -(n1 @ (rt1[:3, :3].T @ (p1.center - rt1[:3, 3])))
                    n2 = rt2[:3, :3].T @ p2.normal
                    d2 = -(n2 @ (rt2[:3, :3].T @ (p2.center - rt2[:3, 3])))
                    # d1/d2 are already the mrpt sensor-frame offsets
                    # (d = -n.c) the joint solver's residual is written in:
                    # d_i - d_j = n_i.t_i - n_j.t_j at the true extrinsics
                    corresp.add(s, s2, n1, d1, n2, d2)
                    added += 1
    return added


def eval_calibration(corresp: PlaneCorrespondences, rt) -> float:
    """Mean squared normal-alignment error over all pairs (EvalCalibration)."""
    errs = []
    for (s1, s2), rows in corresp.rows.items():
        rel = np.linalg.inv(rt[s1]) @ rt[s2]
        for row in rows:
            n1, n2 = row[:3], row[4:7]
            errs.append(float(np.sum((n1 - rel[:3, :3] @ n2) ** 2)))
    return float(np.mean(errs)) if errs else float("nan")


def frames_with_planes(calib, args):
    """(frame_no, Frame360 with its planes) over the dataset, at most
    --max-frames of them, each built on --device."""
    n = 0
    for frame_no, path in sequence_files(args.dataset, args.first, args.sample):
        if n >= args.max_frames:
            return
        frame = Frame360(calib, frame_no, args.device).build(path)
        frame.get_planes()
        n += 1
        yield frame_no, frame


def add_sequence_args(ap: argparse.ArgumentParser, max_frames: int) -> None:
    ap.add_argument("dataset")
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--sample", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=max_frames)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames")


def save_extrinsics(rt: np.ndarray, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    for s in range(8):
        np.savetxt(os.path.join(out, f"Rt_0{s+1}.txt"), rt[s], fmt="%10.6f")
    print(f"calibration -> {out}/Rt_0*.txt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_sequence_args(ap, max_frames=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    corresp = PlaneCorrespondences()
    init_rt = calib.Rt.astype(np.float64)

    for frame_no, frame in frames_with_planes(calib, args):
        with stage("Control-plane gather"):
            added = gather_control_planes(frame, corresp, init_rt)
        print(f"frame {frame_no}: {added} control-plane pairs")

    for s in range(1, 8):
        cond = corresp.conditioning(s - 1, s)
        n = len(corresp.rows.get((s - 1, s), []))
        print(f"pair {s-1}-{s}: {n} correspondences, conditioning {cond:.1f}")

    err_before = eval_calibration(corresp, init_rt)
    with stage("Calibration solve"):
        rt = Calibrator(corresp).calibrate()
    err_after = eval_calibration(corresp, rt)
    print(f"normal-alignment MSE: before {err_before:.6f} after {err_after:.6f}")

    if args.out:
        save_extrinsics(rt, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
