"""ToFCalibrator — extrinsic calibration of a ToF depth camera against an
RGB-D sensor from co-observed planes (reference Calibration/ToFCalibrator.cpp:
both devices segment planes from their depth images; matched plane pairs feed
the decoupled closed-form rotation + LS translation of PairCalibrator).

Counterpart of rgbd360_tpu/apps/tof_calibrator.py. Inputs are two organized
depth images (raw f32 metre binaries as written by
core/frame360_stereo.write_stereo_depth) plus intrinsics; planes are
extracted with the plane layer's device ops on --device (the card unless
named: normals, label propagation and refinement of one pinhole image) and
fitted on the host (plane_extraction._planes_from_labels), matched by
normal/offset agreement under the init guess, and the pair solved. With
--demo a synthetic scene validates the whole chain.

Usage:
  python -m rgbd360_torch.apps.tof_calibrator --rgbd D1.bin --tof D2.bin
         [--fx-tof 280] [--init Rt.txt] [--out FILE] [--device cuda|cpu]
  python -m rgbd360_torch.apps.tof_calibrator --demo [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from rgbd360_torch.core.calibrator import PairCalibrator
from rgbd360_torch.device import resolve_device


def planes_from_depth(depth_m: np.ndarray, fx: float, fy: float, ox: float, oy: float, device=None):
    """Depth image -> list of Plane (sensor frame): the device ops on
    ``device`` (the card unless named), the host fit."""
    from rgbd360_torch.core.plane_extraction import _planes_from_labels
    from rgbd360_torch.ops.normals import organized_normals
    from rgbd360_torch.ops.planes_seg import refine_plane_labels, segment_planes

    h, w = depth_m.shape
    cc, rr = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    z = depth_m.astype(np.float32)
    xyz = np.stack([(cc - ox) * z / fx, (rr - oy) * z / fy, z], axis=-1)
    xyz[z <= 0] = np.nan
    xyz_t = torch.from_numpy(xyz).to(resolve_device(device))[None]
    normals = organized_normals(xyz_t)
    labels = segment_planes(xyz_t, normals)
    labels = refine_plane_labels(labels, xyz_t, normals)
    rgb = np.zeros((h, w, 3), np.uint8)
    return _planes_from_labels(xyz, rgb, labels[0].cpu().numpy(), 0)


def match_planes(planes1, planes2, init_rt, max_angle_cos=0.95, max_d=0.3):
    """Greedy plane association under the init guess."""
    pc = PairCalibrator()
    pc.set_init_rt(init_rt)
    rows = []
    used = set()
    R = init_rt[:3, :3]
    t = init_rt[:3, 3]
    for p1 in planes1:
        best, best_score = None, -1.0
        for j, p2 in enumerate(planes2):
            if j in used:
                continue
            n2_in_1 = R @ p2.normal
            cosang = float(p1.normal @ n2_in_1)
            # mrpt offsets (d = -n.c): under x1 = R x2 + t the plane maps
            # to d1 = d2 - (R n2).t
            d2_in_1 = p2.d - float(n2_in_1 @ t)
            if cosang > max_angle_cos and abs(p1.d - d2_in_1) < max_d and cosang > best_score:
                best, best_score = j, cosang
        if best is not None:
            used.add(best)
            p2 = planes2[best]
            rows.append(np.concatenate([p1.normal, [p1.d], p2.normal, [p2.d]]))
    pc.correspondences = np.stack(rows) if rows else np.zeros((0, 8))
    return pc


def _synthetic_depth(rt, fx, fy, ox, oy, h=120, w=160, seed=0):
    """Depth image of three walls seen from pose rt (camera-from-world)."""
    walls = [
        (np.array([0.0, 0.0, 1.0]), 4.0),
        (np.array([1.0, 0.0, 0.2]) / np.linalg.norm([1.0, 0.0, 0.2]), 2.5),
        (np.array([0.0, 1.0, 0.3]) / np.linalg.norm([0.0, 1.0, 0.3]), 2.0),
    ]
    cc, rr = np.meshgrid(np.arange(w, dtype=float), np.arange(h, dtype=float))
    d_cam = np.stack([(cc - ox) / fx, (rr - oy) / fy, np.ones_like(cc)], -1)
    R, t = rt[:3, :3], rt[:3, 3]
    d_world = d_cam @ R.T
    depth = np.full((h, w), np.inf)
    for n, d in walls:
        denom = d_world @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            s = (d - t @ n) / denom
        depth = np.where((s > 0.3) & (s < depth), s, depth)
    return np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)


def demo_truth() -> np.ndarray:
    """The demo's ToF-from-RGB-D extrinsic."""
    truth = np.eye(4)
    a = 0.15
    truth[:3, :3] = np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    )
    truth[:3, 3] = [0.08, 0.02, -0.05]
    return truth


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rgbd", default=None)
    ap.add_argument("--tof", default=None)
    ap.add_argument("--fx-rgbd", type=float, default=262.5)
    ap.add_argument("--fx-tof", type=float, default=280.0)
    ap.add_argument("--init", default=None, help="4x4 init Rt text file")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the plane extraction")
    args = ap.parse_args(argv)

    if args.demo:
        truth = demo_truth()
        fx = fy = 90.0  # wide FOV so all three walls are seen
        d1 = _synthetic_depth(np.eye(4), fx, fy, 79.5, 59.5)
        d2 = _synthetic_depth(truth, fx, fy, 79.5, 59.5)
        p1 = planes_from_depth(d1, fx, fy, 79.5, 59.5, args.device)
        p2 = planes_from_depth(d2, fx, fy, 79.5, 59.5, args.device)
        init = np.eye(4)
    elif args.rgbd and args.tof:
        from rgbd360_torch.core.frame360_stereo import read_stereo_depth

        truth = None
        d1 = read_stereo_depth(args.rgbd)
        d2 = read_stereo_depth(args.tof)
        fx = args.fx_rgbd
        p1 = planes_from_depth(d1, fx, fx, d1.shape[1] / 2 - 0.5, d1.shape[0] / 2 - 0.5, args.device)
        p2 = planes_from_depth(
            d2, args.fx_tof, args.fx_tof, d2.shape[1] / 2 - 0.5, d2.shape[0] / 2 - 0.5, args.device
        )
        init = np.loadtxt(args.init) if args.init else np.eye(4)
    else:
        ap.error("either --demo or both --rgbd/--tof are required")

    print(f"planes: rgbd={len(p1)} tof={len(p2)}")
    pc = match_planes(p1, p2, init)
    print(f"matched correspondences: {len(pc.correspondences)}")
    est = pc.calibrate_pair()
    if est is None:
        print("calibration not recoverable (conditioning gate)")
        return 1
    print("tof-from-rgbd extrinsic estimate:")
    print(np.array2string(est, precision=6, suppress_small=True))
    if truth is not None:
        print(f"demo ground-truth error: |dR|={np.abs(est[:3,:3]-truth[:3,:3]).max():.2e} "
              f"|dt|={np.linalg.norm(est[:3,3]-truth[:3,3]):.2e}")
    if args.out:
        np.savetxt(args.out, est, fmt="%10.6f")
        print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
