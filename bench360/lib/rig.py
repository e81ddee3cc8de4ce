"""The benchmark's traffic generator: a synthetic 8-sensor rig in a room.

Frozen copy of tools/synthetic_rig.py's captures and calibration root,
with the pieces it took from the program frozen too, so that no change to
the program moves the yardstick:

  construction_specs    rgbd360_torch/core/calibrator.py (Calibrator.h:763-776)
  qvga_camera_matrix    rgbd360_torch/io/calib.py (Calib360.h:74-77)
  write_frame360_bin    rgbd360_torch/io/boost_archive.py (Frame360.h:333-345)
  write_clams_model     tools/synthetic_rig.py, with the CLAMS v01 magic of
                        rgbd360_torch/io/clams.py

It writes what a real dataset holds, in the reference's file formats:
<root>/Calibration/{Extrinsics/Rt_0N.txt, Intrinsics/distortion_modelN},
<root>/config_files/configLocaliser_sphericalOdometry.ini (empty: the
matcher's defaults) and <dataset>/sphere_images_N.bin: captures of a
textured box room with two pillars, ray-cast through the rig along a
circle. bench360/tests holds it to tools/synthetic_rig.py byte for byte.
Imports numpy only.
"""

from __future__ import annotations

import multiprocessing
import os
import struct
from concurrent.futures import ProcessPoolExecutor

import numpy as np

NUM_SENSORS = 8
PLANAR_SPREAD = 0.002  # CLAMS multipliers within 1 +- 0.2%: the room stays planar
MATCHER_INI = os.path.join("config_files", "configLocaliser_sphericalOdometry.ini")
CLAMS_MAGIC = b"DiscreteDepthDistortionModel v01\n"

DEFAULT_BOX = (-1.5, 1.5, -2.2, 3.4, -3.0, 2.4)
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


def construction_specs() -> np.ndarray:
    """The ideal rig: sensor 0 at t = (0, 0, 0.055), each next one a 45 deg
    turn about the vertical (x) axis of the previous. (8, 4, 4) float64."""
    rts = np.tile(np.eye(4, dtype=np.float64), (NUM_SENSORS, 1, 1))
    rts[0, 2, 3] = 0.055
    a = np.deg2rad(45.0)
    c, si = np.cos(a), np.sin(a)
    turn45 = np.eye(4)
    turn45[1, 1] = turn45[2, 2] = c
    turn45[1, 2] = -si
    turn45[2, 1] = si
    for s in range(1, NUM_SENSORS):
        rts[s] = turn45 @ rts[s - 1]
    return rts


def qvga_camera_matrix() -> np.ndarray:
    return np.array([[262.5, 0.0, 159.5], [0.0, 262.5, 119.5], [0.0, 0.0, 1.0]], np.float32)


def loop_pose(theta: float, radius: float, center=(0.0, 0.6, -0.3)) -> np.ndarray:
    """Rig pose on the circle, yawed about the vertical (x) axis with the tangent."""
    cx, cy, cz = center
    pose = np.eye(4)
    c, s = np.cos(theta), np.sin(theta)
    pose[1, 1], pose[1, 2] = c, -s
    pose[2, 1], pose[2, 2] = s, c
    pose[1, 3] = cy + radius * np.sin(theta)
    pose[2, 3] = cz + radius * (np.cos(theta) - 1.0)
    pose[0, 3] = cx
    return pose


def circle_poses(frames: int, deg_per_step: float, radius: float) -> np.ndarray:
    """The (frames, 4, 4) rig poses 2 pi loops i / frames along the circle,
    loops = frames deg_per_step / 360 (tools/synthetic_rig.write_sequence)."""
    loops = frames * deg_per_step / 360.0
    return np.stack([loop_pose(2.0 * np.pi * loops * i / frames, radius) for i in range(frames)])


def raycast_room_sensor(rt, w=320, h=240, box=DEFAULT_BOX, obstacles=()):
    """(rgb (h,w,3) u8 BGR, depth_mm (h,w) u16) of one pinhole sensor at rig pose rt."""
    K = qvga_camera_matrix()
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, float)], -1)
    R, t = rt[:3, :3].astype(np.float64), rt[:3, 3].astype(np.float64)
    best_s, face_id, hit_pt = _raycast(t, d_cam @ R.T, box, obstacles)
    depth_m = best_s * d_cam[..., 2]
    depth_mm = np.clip(np.nan_to_num(depth_m) * 1000.0, 0, 60000).astype(np.uint16)
    return _shade(hit_pt, face_id), depth_mm


def _raycast(o, d_world, box, obstacles):
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


def _mat_record(mat: np.ndarray) -> bytes:
    """One cv::Mat record of the boost archive: cols, rows, elem size, type, data."""
    channels = 1 if mat.ndim == 2 else mat.shape[2]
    depth = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 2}[np.dtype(mat.dtype)]
    head = struct.pack("<iiQQ", mat.shape[1], mat.shape[0], mat.dtype.itemsize * channels,
                       depth + ((channels - 1) << 3))
    return head + np.ascontiguousarray(mat).tobytes()


def write_frame360_bin(path: str, rgb: np.ndarray, depth: np.ndarray, timestamp: int) -> None:
    """The reference's raw capture: 8 (rgb, depth) cv::Mat pairs and the
    timestamp as a 1 x digits CV_8U matrix, in a boost binary archive."""
    sig = b"serialization::archive"
    out = bytearray(struct.pack("<Q", len(sig)) + sig + struct.pack("<H", 9) + bytes([4, 8, 4, 8]))
    out += b"\x01" + b"\x00" * 8
    for s in range(NUM_SENSORS):
        out += _mat_record(rgb[s]) + _mat_record(depth[s])
    if timestamp > 0:
        digits = np.frombuffer(str(int(timestamp)).encode(), np.uint8) - ord("0")
        out += _mat_record(digits.reshape(1, -1))
    else:
        out += struct.pack("<iiQQ", 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(bytes(out))


def clams_arrays(seed: int, bins_xy=(80, 80), n_depth: int = 5, spread: float = 0.05):
    """Seeded (multipliers, counts) of a VGA CLAMS model, each (by, bx, n_depth) f32."""
    rng = np.random.default_rng(seed)
    by, bx = bins_xy[1], bins_xy[0]
    mults = rng.uniform(1.0 - spread, 1.0 + spread, (by, bx, n_depth)).astype(np.float32)
    counts = rng.choice(np.array([0.0, 20.0, 80.0, 500.0], np.float32), size=(by, bx, n_depth),
                        p=[0.1, 0.1, 0.2, 0.6])
    return mults, counts.astype(np.float32)


def write_clams_model(path: str, mults: np.ndarray, counts: np.ndarray, width=640, height=480,
                      bin_width=8, bin_height=6, bin_depth=2.0) -> None:
    """A CLAMS v01 binary (discrete_depth_distortion_model.cpp:242-281)."""
    by, bx, n = mults.shape

    def vec(x):
        x = np.ascontiguousarray(x, np.float32)
        return struct.pack("<iii", 4, x.size, 1) + x.tobytes()

    out = bytearray(CLAMS_MAGIC)
    out += struct.pack("<iiii", width, height, bin_width, bin_height)
    out += struct.pack("<d", bin_depth)
    out += struct.pack("<ii", bx, by)
    for y in range(by):
        for x in range(bx):
            out += struct.pack("<did", n * bin_depth, n, bin_depth)
            c = counts[y, x]
            out += vec(c) + vec(c * mults[y, x]) + vec(c) + vec(mults[y, x])
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_calib_root(root: str, seed: int, spread: float = PLANAR_SPREAD) -> np.ndarray:
    """The construction-spec extrinsics, seeded CLAMS models (sensor s from
    seed + s) and the empty matcher .ini under ``root``."""
    rts = construction_specs()
    ext = os.path.join(root, "Calibration", "Extrinsics")
    intr = os.path.join(root, "Calibration", "Intrinsics")
    os.makedirs(ext, exist_ok=True)
    os.makedirs(intr, exist_ok=True)
    for s in range(NUM_SENSORS):
        np.savetxt(os.path.join(ext, f"Rt_0{s + 1}.txt"), rts[s])
        write_clams_model(os.path.join(intr, f"distortion_model{s + 1}"), *clams_arrays(seed + s, spread=spread))
    os.makedirs(os.path.join(root, "config_files"), exist_ok=True)
    open(os.path.join(root, MATCHER_INI), "w").close()
    return rts


def write_capture(path: str, pose: np.ndarray, rts: np.ndarray, timestamp: int) -> None:
    """Ray-cast the 8 sensors at rig pose ``pose`` and write the capture."""
    rgbs, depths = [], []
    for s in range(NUM_SENSORS):
        rgb, depth = raycast_room_sensor(pose @ np.asarray(rts[s], np.float64), obstacles=OBSTACLES)
        rgbs.append(rgb)
        depths.append(depth)
    write_frame360_bin(path, np.stack(rgbs), np.stack(depths), timestamp)


def write_captures(out: str, poses: np.ndarray, indices, rts: np.ndarray, workers: int) -> list:
    """sphere_images_<i + 1>.bin for each index i of ``poses``, ray-cast in
    ``workers`` spawned processes. Returns the paths in index order."""
    os.makedirs(out, exist_ok=True)
    jobs = [(os.path.join(out, f"sphere_images_{i + 1}.bin"), poses[i], rts, 10_000_000 * (i + 1)) for i in indices]
    if workers > 1:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(write_capture, *zip(*jobs)))
    else:
        for job in jobs:
            write_capture(*job)
    return [job[0] for job in jobs]
