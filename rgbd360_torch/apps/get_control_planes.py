"""GetControlPlanes — gather cross-sensor control-plane correspondences from
a sphere sequence and save them per sensor pair
(reference Calibration/GetControlPlanes.cpp: accumulates
ControlPlanes.mmCorrespondences matrices from matched planes in adjacent
sensors' overlap; the saved matrices feed Calibrator/EvalCalibration).

Counterpart of rgbd360_tpu/apps/get_control_planes.py; the frames and their
planes on --device (the card unless named). The files are the JAX app's:
correspondences_i_j.txt per pair and control_planes.npz, which either
package loads.

Usage: python -m rgbd360_torch.apps.get_control_planes <dataset_dir>
       [--first 1] [--sample 1] [--max-frames 10] --out DIR
       [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rgbd360_torch.apps.calibrate_rig import add_sequence_args, frames_with_planes, gather_control_planes
from rgbd360_torch.apps.common import load_calib
from rgbd360_torch.core.calibrator import PlaneCorrespondences


def save_correspondences(corresp: PlaneCorrespondences, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for (s1, s2), rows in sorted(corresp.rows.items()):
        m = np.stack(rows)
        np.savetxt(
            os.path.join(out_dir, f"correspondences_{s1}_{s2}.txt"), m, fmt="%12.8f"
        )
    np.savez(
        os.path.join(out_dir, "control_planes.npz"),
        **{f"pair_{s1}_{s2}": np.stack(rows) for (s1, s2), rows in corresp.rows.items()},
    )


def load_correspondences(path: str) -> PlaneCorrespondences:
    """Load control planes saved by save_correspondences (.npz)."""
    corresp = PlaneCorrespondences()
    with np.load(path) as data:
        for key in data.files:
            _, s1, s2 = key.rsplit("_", 2)
            for row in data[key]:
                corresp.add(int(s1), int(s2), row[:3], row[3], row[4:7], row[7])
    return corresp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_sequence_args(ap, max_frames=10)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    corresp = PlaneCorrespondences()
    init_rt = calib.Rt.astype(np.float64)

    for frame_no, frame in frames_with_planes(calib, args):
        added = gather_control_planes(frame, corresp, init_rt)
        print(f"frame {frame_no}: {added} control-plane pairs")

    total = sum(len(rows) for rows in corresp.rows.values())
    print(f"{total} correspondences over {len(corresp.rows)} sensor pairs")
    save_correspondences(corresp, args.out)
    print(f"saved -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
