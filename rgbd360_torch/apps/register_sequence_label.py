"""RegisterSequenceSphere_labelFast — fast PbMap-only registration of a
sequence of *saved, labelized* keyframes (reference
Registration/RegisterSequenceSphere_labelFast.cpp:46-213): walk the
sphereCloud_%d.pcd / spherePlanes_%d.pbmap dumps, skip frames with no
labeled plane (:76-87,:153-168), PbMap-register each consecutive labeled
pair at PLANAR_3DoF with labeled planes force-included in the subgraphs
(:175), chain the pose (:181), and report matching-time / label statistics
(:199-209). The PCL viewer becomes a trajectory + merged-cloud export.

Counterpart of rgbd360_tpu/apps/register_sequence_label.py, over keyframes
saved by Frame360.save (core/map_io.py writes them); their panoramas go to
--device (the card unless named), the PbMap work is host numpy.

Usage: python -m rgbd360_torch.apps.register_sequence_label <kf_dir>
       [--out DIR] [--max-frames N] [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from rgbd360_torch.apps.common import load_calib, rot_offset
from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.core.matcher import PLANAR_3DOF
from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360
from rgbd360_torch.utils.viz import save_ply, save_trajectory

MAX_MATCH_PLANES = 25  # RegisterSequenceSphere_labelFast.cpp:39


def keyframe_numbers(kf_dir: str):
    """Frame numbers with a saved PbMap, ascending (the reference probes
    spherePlanes_%d.pbmap existence, :121)."""
    nums = []
    for name in os.listdir(kf_dir):
        if name.startswith("spherePlanes_") and name.endswith(".pbmap.npz"):
            nums.append(int(name[len("spherePlanes_"):].split(".")[0]))
    return sorted(nums)


def count_labels(frame) -> int:
    """# planes carrying a semantic label (:83-85)."""
    return sum(1 for p in frame.planes.planes if p.label)


def run(kf_dir: str, out_dir=None, max_frames=None, calib_root=None, device=None) -> dict:
    """The app over the keyframes in ``kf_dir``; returns the statistics and
    the trajectory (register_sequence_label.py:46)."""
    calib = load_calib(calib_root)
    registerer = RegisterRGBD360()
    off = rot_offset()

    nums = keyframe_numbers(kf_dir)
    if max_frames:
        nums = nums[:max_frames]

    prev = None
    pose = np.eye(4, dtype=np.float64)
    trajectory = []
    clouds, colors = [], []
    labelized = unlabelized = 0
    time_matching = 0.0
    av_labels = 0.0

    for frame_no in nums:
        frame = Frame360.load_keyframe(calib, kf_dir, frame_no, device)
        n_labels = count_labels(frame)
        if n_labels == 0:
            # skip non-labelized frames (:76-87, :153-168)
            unlabelized += 1
            print(f"frame {frame_no}: NO LABELS")
            continue

        export_ok = True
        if prev is None:
            prev = frame
            trajectory.append(pose.copy())
            print(f"frame {frame_no}: reference ({n_labels} labels)")
        else:
            labelized += 1
            av_labels += n_labels
            t0 = time.perf_counter()
            ok = registerer.register_pbmap(prev, frame, MAX_MATCH_PLANES, PLANAR_3DOF)
            dt = time.perf_counter() - t0
            time_matching += dt * 1000.0
            if ok:
                pose = pose @ registerer.get_pose().astype(np.float64)
                print(
                    f"frame {frame_no}: matched={len(registerer.get_matched_planes())} "
                    f"labels={n_labels} |t|={np.linalg.norm(registerer.get_pose()[:3, 3]):.4f} "
                    f"T={dt * 1000.0:.1f} ms"
                )
            else:
                print(f"frame {frame_no}: REGISTRATION FAILED (labels={n_labels}, "
                      f"T={dt * 1000.0:.1f} ms)")
            trajectory.append(pose.copy())
            prev = frame  # the reference advances prev unconditionally (:127)
            # a failed registration would overlay this frame's geometry at
            # the stale pose — keep it out of the merged export
            export_ok = ok

        if out_dir and export_ok and frame.sphere_cloud is not None:
            xyz, rgb = frame.sphere_cloud
            xyz = np.asarray(xyz).reshape(-1, 3)
            keep = np.isfinite(xyz).all(axis=1) & (np.abs(xyz) < 20).all(axis=1)
            # the saved keyframe cloud lives in the SPHERE frame while the
            # PbMap pose chain is in the rig/cloud frame: conjugate through
            # the 157.5-deg offset (register_pair.py does the same)
            pose_s = off @ pose @ np.linalg.inv(off)
            clouds.append(xyz[keep] @ pose_s[:3, :3].T + pose_s[:3, 3])
            colors.append(np.asarray(rgb).reshape(-1, 3)[keep])

    stats = {
        "labelized": labelized,
        "unlabelized": unlabelized,
        "av_time_ms": time_matching / max(labelized, 1),
        "av_labels": av_labels / max(labelized, 1),
        "trajectory": trajectory,
    }
    print(
        f"Stats: avTime {stats['av_time_ms']:.1f} ms avLabels {stats['av_labels']:.1f} "
        f"labelized {labelized} unlabelized {unlabelized}"
    )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        save_trajectory(os.path.join(out_dir, "trajectory.txt"), trajectory)
        if clouds:
            save_ply(
                os.path.join(out_dir, "global_map.ply"),
                np.concatenate(clouds),
                np.concatenate(colors),
            )
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("kf_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the keyframes' panoramas")
    args = ap.parse_args(argv)
    run(args.kf_dir, args.out, args.max_frames, args.calib_root, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
