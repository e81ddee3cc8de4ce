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

and, for the MRPT rawlog loader (write_rawlog_sequence), a rawlog of the
same room seen by a 4-sensor rig.

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
    best_s, face_id, hit_pt = _raycast(t, d_cam @ R.T, box, obstacles)
    depth_m = best_s * d_cam[..., 2]  # z-depth (d_cam z == 1)
    depth_mm = np.clip(np.nan_to_num(depth_m) * 1000.0, 0, 60000).astype(np.uint16)
    return _shade(hit_pt, face_id), depth_mm


def _raycast(o, d_world, box, obstacles):
    """Nearest hit of the rays o + s d_world (s > 0.05) on the box interior
    and the obstacles' faces: (s (h,w), face id (h,w), hit point (h,w,3))."""
    h, w = d_world.shape[:2]
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
    return best_s, face_id, hit_pt


def _shade(hit_pt, face_id):
    """The room's texture at the hit points: (h,w,3) u8 BGR."""
    a = hit_pt[..., (0, 1)].sum(-1)
    b = hit_pt[..., (1, 2)].sum(-1)
    gray = (
        120
        + 60 * np.sin(3.0 * a + face_id)
        + 50 * np.cos(4.0 * b + 2.0 * face_id)
        + 15 * np.sin(11.0 * a)
    ).clip(0, 255)
    tint = _FACE_TINT[np.maximum(face_id, 0) % 6]
    return (gray[..., None] * tint).clip(0, 255).astype(np.uint8)


# the stereo panorama (rgbd360_torch/core/frame360_stereo.py): 1024 columns
# over 2 pi, and start_phi = 166 centres phi = 0 on row 90 of 180, so the
# rows hold the symmetric +-31.6 deg band, the ~60 deg band Frame360's
# 1920 x 320 keeps
STEREO_H, STEREO_W, STEREO_START_PHI = 180, 1024, 166


def stereo_pose(position=(0.0, 0.6, -0.3)) -> np.ndarray:
    """A stereo device in the room: its y axis (the panorama's elevation)
    along the room's vertical x axis, its z axis along the room's z."""
    pose = np.eye(4)
    pose[:3, :3] = [[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    pose[:3, 3] = position
    return pose


def raycast_room_stereo(pose, h=STEREO_H, w=STEREO_W, start_phi=STEREO_START_PHI, box=DEFAULT_BOX,
                        obstacles=OBSTACLES):
    """Ray-cast the room through a stereo panorama at ``pose``, in the
    backprojection convention of Frame360_stereo.h:454-517: row r, column c
    look along phi = (r + start_phi) 2pi/w - pi/2, theta = c 2pi/w - pi,
    direction (sin theta cos phi, sin phi, cos theta cos phi), and the depth
    is the range along it. Returns (rgb (h,w,3) u8 BGR, depth (h,w) f32
    metres, 0 where no surface)."""
    step = 2.0 * np.pi / w
    phi = (np.arange(h) + start_phi) * step - np.pi / 2
    theta = np.arange(w) * step - np.pi
    d_cam = np.stack(np.broadcast_arrays(
        np.sin(theta)[None, :] * np.cos(phi)[:, None], np.sin(phi)[:, None],
        np.cos(theta)[None, :] * np.cos(phi)[:, None]), axis=-1)
    pose = np.asarray(pose, np.float64)
    best_s, face_id, hit_pt = _raycast(pose[:3, 3], d_cam @ pose[:3, :3].T, box, obstacles)
    depth = np.where(np.isfinite(best_s), best_s, 0.0).astype(np.float32)
    return _shade(hit_pt, face_id), depth


def perturbed_rig(seed: int = 0, deg: float = 1.0, mm: float = 5.0) -> np.ndarray:
    """The construction-spec rig with each of sensors 1-7 turned by ``deg``
    about a random axis and shifted by N(0, ``mm``) per axis, drawn from
    np.random.default_rng(seed): a rig to calibrate (the sensors' true
    poses; its calibration root still holds the construction specs)."""
    rng = np.random.default_rng(seed)
    rts = construction_specs()
    for s in range(1, 8):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]], [-axis[1], axis[0], 0.0]])
        a = np.deg2rad(deg)
        rts[s, :3, :3] = (np.eye(3) + np.sin(a) * K + (1.0 - np.cos(a)) * K @ K) @ rts[s, :3, :3]
        rts[s, :3, 3] += rng.normal(0.0, mm * 1e-3, 3)
    return rts


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


def write_rawlog_sequence(path: str, rts: np.ndarray, frames: int = 3, radius: float = 0.8) -> np.ndarray:
    """An MRPT rawlog (rgbd360_torch/io/rawlog.py) of the room: per frame,
    CObservation3DRangeScan records RGBD1..RGBD4 (intensity u8 BGR as a raw
    CImage, range f32 metres, 320 x 240) and one LASER
    CObservation2DRangeScan the loader skips. Sensor i is ray-cast at the
    rig pose of the first slot that apps/load_rawlog.py's SENSOR_ARRANGEMENT
    fills from it; the rig moves along loop_pose as write_sequence's does.
    Returns the (frames, 4, 4) rig poses."""
    from rgbd360_torch.io.rawlog import Obs2DRangeScan, Obs3DRangeScan, write_rawlog

    arrangement = (3, 0, 2, 1, 3, 0, 2, 1)  # apps/load_rawlog.py::SENSOR_ARRANGEMENT
    poses = [loop_pose(2.0 * np.pi * 0.1 * i / 6, radius) for i in range(frames)]
    observations = []
    for i, pose in enumerate(poses):
        stamp = 10_000_000 * (i + 1)
        for sensor in range(4):
            rt = pose @ np.asarray(rts[arrangement.index(sensor)], np.float64)
            rgb, depth_mm = raycast_room_sensor(rt, obstacles=OBSTACLES)
            observations.append(Obs3DRangeScan(
                sensor_label=f"RGBD{sensor + 1}", timestamp=stamp + sensor, sensor_pose=rt,
                range_image=depth_mm.astype(np.float32) * np.float32(0.001), intensity_image=rgb,
            ))
        observations.append(Obs2DRangeScan(timestamp=stamp + 9, ranges=np.full(181, 2.5, np.float32)))
    write_rawlog(path, observations)
    return np.stack(poses)


def control_plane_observations(seed: int = 0, planes_per_pair: int = 6, noise: float = 1e-3):
    """Seeded control planes of perturbed_rig(seed): random world planes
    seen by each adjacent sensor pair (the 7-0 ring pair included), each in
    its sensor's frame and mrpt's offset convention (d = d_world + n_world .
    t_sensor), the normals with N(0, ``noise``) per axis. A list of
    PlaneCorrespondences.add arguments (s1, s2, n1, d1, n2, d2)."""
    rng = np.random.default_rng(seed)
    true = perturbed_rig(seed)
    out = []
    for s in range(8):
        s2 = (s + 1) % 8
        for _ in range(planes_per_pair):
            n_w = rng.normal(size=3)
            n_w /= np.linalg.norm(n_w)
            d_w = rng.uniform(-4.0, -1.0)
            obs = []
            for k in (s, s2):
                n = true[k, :3, :3].T @ n_w + rng.normal(0.0, noise, 3)
                obs += [n / np.linalg.norm(n), d_w + n_w @ true[k, :3, 3]]
            out.append((s, s2, *obs))
    return out


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
