"""A synthetic rig and capture sequence for the port, without JAX.

Writes what a real dataset holds, in the reference's file formats:

  <root>/Calibration/Extrinsics/Rt_0N.txt    the construction-spec rig
                                             (rgbd360_torch/core/calibrator.py)
  <root>/Calibration/Intrinsics/distortion_modelN
                                             a seeded CLAMS v01 model per
                                             sensor, multipliers != 1
  <root>/config_files/configLocaliser_sphericalOdometry.ini
                                             the PbMap matcher .ini, empty:
                                             MatcherConfig's defaults
  <dataset>/sphere_images_N.bin              8-sensor captures of a textured
                                             box room with two pillars,
                                             ray-cast through the rig along
                                             a circle (tests/room_scene.py,
                                             tools/make_synthetic_sequence.py)
  <dataset>/poses_gt.txt                     the rig poses, one 4x4 per line

The ray-caster and the trajectory are copies of tests/room_scene.py and
tools/make_synthetic_sequence.py, which reach the JAX package for the
camera matrix and the file writer; tests/test_torch_frame.py holds the copy
to the original bit for bit. chip_smoke.py and the port's tests share this
module.

Usage: python tools/synthetic_rig.py --out DIR [--frames 6] [--loops 0.1]
           [--radius 0.8] [--seed 0]
       writes DIR/calib (the calibration root) and DIR/seq (the dataset).
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rgbd360_torch.core.calibrator import construction_specs  # noqa: E402
from rgbd360_torch.io.boost_archive import RawFrame360, write_frame360_bin  # noqa: E402
from rgbd360_torch.io.calib import qvga_camera_matrix  # noqa: E402
from rgbd360_torch.io.clams import MAGIC, DepthDistortionModel  # noqa: E402

# Ground-truth bound of the dense odometry on write_sequence's default
# dataset, per relative pose: the JAX app measured at most 7.0 mm and
# 0.202 deg on its 5 pairs (CPU), the port the same to 1e-5 m
GT_T = 0.010  # metres
GT_ROT_DEG = 0.3

# Spread of the multipliers of the calibration roots write_calib_root
# makes: within +-0.2% of 1 per bin, the walls, floor, ceiling and pillars
# of the room stay planes to the plane layer (about 12 per frame). At +-5%
# the bin-to-bin depth steps make the normals' depth-change test reject
# most pixels, and no plane survives.
PLANAR_SPREAD = 0.002
MATCHER_INI = os.path.join("config_files", "configLocaliser_sphericalOdometry.ini")

# tests/room_scene.py:11: asymmetric walls, so no 90-degree symmetry
DEFAULT_BOX = (-1.5, 1.5, -2.2, 3.4, -3.0, 2.4)
# tools/make_synthetic_sequence.py:71-74: pillars clear of the circle
OBSTACLES = (
    (-1.5, 0.5, 2.0, 2.6, -2.2, -1.6),
    (-1.5, 0.5, -1.8, -1.2, -1.4, -0.8),
)
_FACE_TINT = np.array(
    [
        [1.0, 0.35, 0.35],
        [0.35, 1.0, 0.35],
        [0.35, 0.35, 1.0],
        [0.3, 0.85, 1.0],
        [1.0, 0.85, 0.3],
        [0.85, 0.3, 1.0],
    ]
)


def loop_pose(theta: float, radius: float, center=(0.0, 0.6, -0.3)) -> np.ndarray:
    """Rig pose on the circle, yawed about the vertical (x) axis with the
    tangent (tools/make_synthetic_sequence.py:40)."""
    cx, cy, cz = center
    pose = np.eye(4)
    c, s = np.cos(theta), np.sin(theta)
    pose[1, 1], pose[1, 2] = c, -s
    pose[2, 1], pose[2, 2] = s, c
    pose[1, 3] = cy + radius * np.sin(theta)
    pose[2, 3] = cz + radius * (np.cos(theta) - 1.0)
    pose[0, 3] = cx
    return pose


def raycast_room_sensor(rt, w=320, h=240, box=DEFAULT_BOX, obstacles=()):
    """Ray-cast the box interior (and the exterior faces of ``obstacles``)
    through one pinhole sensor at rig pose rt (tests/room_scene.py:14).
    Returns (rgb (h,w,3) u8 BGR, depth_mm (h,w) u16)."""
    K = qvga_camera_matrix()
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, float)], -1)
    R, t = rt[:3, :3].astype(np.float64), rt[:3, 3].astype(np.float64)
    d_world = d_cam @ R.T
    o = t

    best_s = np.full((h, w), np.inf)
    face_id = np.full((h, w), -1)
    hit_pt = np.zeros((h, w, 3))
    fid = 0
    for bx in (box,) + tuple(obstacles):
        x0, x1, y0, y1, z0, z1 = bx
        bounds = [(0, x0), (0, x1), (1, y0), (1, y1), (2, z0), (2, z1)]
        for ax, val in bounds:
            da = d_world[..., ax]
            with np.errstate(divide="ignore", invalid="ignore"):
                s = (val - o[ax]) / da
            p = o + s[..., None] * d_world
            inside = np.ones((h, w), bool)
            for ax2, (lo, hi) in zip((0, 1, 2), ((x0, x1), (y0, y1), (z0, z1))):
                if ax2 == ax:
                    continue
                inside &= (p[..., ax2] >= lo - 1e-9) & (p[..., ax2] <= hi + 1e-9)
            ok = (s > 0.05) & inside & (s < best_s)
            best_s = np.where(ok, s, best_s)
            face_id = np.where(ok, fid, face_id)
            hit_pt = np.where(ok[..., None], p, hit_pt)
            fid += 1

    depth_m = best_s * d_cam[..., 2]  # z-depth (d_cam z == 1)
    depth_mm = np.clip(np.nan_to_num(depth_m) * 1000.0, 0, 60000).astype(np.uint16)
    a = hit_pt[..., (0, 1)].sum(-1)
    b = hit_pt[..., (1, 2)].sum(-1)
    gray = (
        120
        + 60 * np.sin(3.0 * a + face_id)
        + 50 * np.cos(4.0 * b + 2.0 * face_id)
        + 15 * np.sin(11.0 * a)
    ).clip(0, 255)
    tint = _FACE_TINT[np.maximum(face_id, 0) % 6]
    rgb = (gray[..., None] * tint).clip(0, 255).astype(np.uint8)
    return rgb, depth_mm


def synthetic_clams_model(seed: int, bins_xy=(80, 80), n_depth: int = 5, spread: float = 0.05) -> DepthDistortionModel:
    """A VGA CLAMS model with the shipped geometry (8x6-pixel bins, 2 m
    depth bins) and seeded multipliers drawn from [1 - spread, 1 + spread]. Its
    counts are 0, 20, 80 or 500 per bin, so some bracketing depth-bin pairs
    fall under the 50-count minimum: undistort takes the nearest-bin branch
    there and interpolates elsewhere."""
    rng = np.random.default_rng(seed)
    by, bx = bins_xy[1], bins_xy[0]
    mults = rng.uniform(1.0 - spread, 1.0 + spread, (by, bx, n_depth)).astype(np.float32)
    counts = rng.choice(np.array([0.0, 20.0, 80.0, 500.0], np.float32), size=(by, bx, n_depth), p=[0.1, 0.1, 0.2, 0.6])
    return DepthDistortionModel(
        width=640, height=480, bin_width=8, bin_height=6, bin_depth=2.0,
        multipliers=mults, counts=counts.astype(np.float32),
    )


def write_clams_model(path: str, model: DepthDistortionModel) -> None:
    """Write ``model`` as a CLAMS v01 binary: the inverse of
    io/clams.py::load_clams_model (reference
    discrete_depth_distortion_model.cpp:242-281)."""
    by, bx, n = model.multipliers.shape

    def vec(x):
        x = np.ascontiguousarray(x, np.float32)
        return struct.pack("<iii", 4, x.size, 1) + x.tobytes()

    out = bytearray(MAGIC)
    out += struct.pack("<iiii", model.width, model.height, model.bin_width, model.bin_height)
    out += struct.pack("<d", model.bin_depth)
    out += struct.pack("<ii", bx, by)
    for y in range(by):
        for x in range(bx):
            out += struct.pack("<did", n * model.bin_depth, n, model.bin_depth)
            counts = model.counts[y, x]
            # numerators / denominators are training sums the reader skips;
            # written consistent with the multipliers
            out += vec(counts) + vec(counts * model.multipliers[y, x]) + vec(counts) + vec(model.multipliers[y, x])
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_calib_root(root: str, seed: int = 0, spread: float = PLANAR_SPREAD) -> np.ndarray:
    """Calibration/{Extrinsics,Intrinsics} of the construction-spec rig
    (CLAMS multipliers within 1 +- ``spread``) and the matcher .ini under
    ``root``. Returns the (8, 4, 4) extrinsics."""
    rts = construction_specs()
    ext = os.path.join(root, "Calibration", "Extrinsics")
    intr = os.path.join(root, "Calibration", "Intrinsics")
    os.makedirs(ext, exist_ok=True)
    os.makedirs(intr, exist_ok=True)
    for s in range(8):
        np.savetxt(os.path.join(ext, f"Rt_0{s + 1}.txt"), rts[s])
        write_clams_model(os.path.join(intr, f"distortion_model{s + 1}"), synthetic_clams_model(seed + s, spread=spread))
    os.makedirs(os.path.join(root, "config_files"), exist_ok=True)
    open(os.path.join(root, MATCHER_INI), "w").close()
    return rts


def room_capture(pose: np.ndarray, rts: np.ndarray, obstacles=OBSTACLES) -> RawFrame360:
    """The 8 sensor images of the room seen from rig pose ``pose``."""
    rgbs, depths = [], []
    for s in range(8):
        rgb, depth = raycast_room_sensor(pose @ np.asarray(rts[s], np.float64), obstacles=obstacles)
        rgbs.append(rgb)
        depths.append(depth)
    return RawFrame360(rgb=np.stack(rgbs), depth=np.stack(depths))


def _write_capture(path: str, pose: np.ndarray, rts: np.ndarray, timestamp: int) -> None:
    raw = room_capture(pose, rts)
    raw.timestamp = timestamp
    write_frame360_bin(path, raw)


def write_sequence(out: str, rts: np.ndarray, frames: int = 6, loops: float = 0.1,
                   radius: float = 0.8, start: int = 1, workers: int = 1) -> np.ndarray:
    """sphere_images_<start..>.bin along loop_pose(2*pi*loops*i/frames,
    radius), plus poses_gt.txt. Returns the (frames, 4, 4) rig poses.
    ``workers`` > 1 ray-casts the captures in that many processes (the
    files are the same)."""
    os.makedirs(out, exist_ok=True)
    poses = [loop_pose(2.0 * np.pi * loops * i / frames, radius) for i in range(frames)]
    jobs = [(os.path.join(out, f"sphere_images_{start + i}.bin"), pose, rts, 10_000_000 * (i + 1))
            for i, pose in enumerate(poses)]
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("fork")) as pool:
            list(pool.map(_write_capture, *zip(*jobs)))
    else:
        for job in jobs:
            _write_capture(*job)
    with open(os.path.join(out, "poses_gt.txt"), "w") as f:
        for pose in poses:
            f.write(" ".join(f"{v:.9g}" for v in pose.ravel()) + "\n")
    return np.stack(poses)


def relative_pose_errors(trajectory, ground_truth) -> np.ndarray:
    """(n-1, 2): per consecutive pair, the translation (m) and rotation (deg)
    between the estimated relative pose inv(T[i-1]) @ T[i] and the true one."""
    rel = lambda T: [np.linalg.inv(T[i - 1]) @ T[i] for i in range(1, len(T))]
    errs = []
    for est, true in zip(rel(np.asarray(trajectory)), rel(np.asarray(ground_truth))):
        cos = np.clip((np.trace(est[:3, :3].T @ true[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        errs.append((np.linalg.norm(est[:3, 3] - true[:3, 3]), np.degrees(np.arccos(cos))))
    return np.array(errs).reshape(-1, 2)


def absolute_trajectory_error(trajectory, ground_truth) -> float:
    """RMS translation error (m) of the trajectory against the ground truth,
    both expressed relative to their first pose (the SLAM apps start at the
    identity)."""
    est, true = np.asarray(trajectory, np.float64), np.asarray(ground_truth, np.float64)
    true = np.linalg.inv(true[0]) @ true
    est = np.linalg.inv(est[0]) @ est
    return float(np.sqrt(np.mean(np.sum((est[:, :3, 3] - true[:, :3, 3]) ** 2, axis=1))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--loops", type=float, default=0.1)
    ap.add_argument("--radius", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rts = write_calib_root(os.path.join(args.out, "calib"), args.seed)
    write_sequence(os.path.join(args.out, "seq"), rts, args.frames, args.loops, args.radius)
    print(f"calibration root {args.out}/calib, {args.frames} frames in {args.out}/seq")
    return 0


if __name__ == "__main__":
    sys.exit(main())
