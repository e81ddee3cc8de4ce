"""LoadRawlog — build calibrated omnidirectional RGB-D frames from an MRPT
rawlog dataset (reference Visualization/LoadRawlog.cpp:58-451).

Counterpart of rgbd360_tpu/apps/load_rawlog.py. Stream the rawlog
(:182-188), collect CObservation3DRangeScan records by sensor label
RGBD1..RGBD4 (:199-218, LASER observations skipped :219-222), emit one
omnidirectional observation when all four sensors have reported
(:230-233), apply frame decimation (:235-238), fan the 4 physical sensors
into the 8 rig slots via SensorArrangement {3,0,2,1,3,0,2,1} (:72,
:245-250), convert the float range image to u16 millimetres (:267-272),
then run the requested mode: panorama images (mode 1/2 :303-322),
undistorted sphere cloud (mode 3 :324-337) or keyframe save (mode 4
:339). The parsing is host numpy (io/rawlog.py); the stitch, the clouds
and the plane program run on the card unless --device names another
device.

Usage: python -m rgbd360_torch.apps.load_rawlog DATASET.rawlog --out DIR
       [--mode images|cloud|save] [--decimation 1] [--max-frames N]
       [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from rgbd360_torch.apps.common import load_calib
from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.io.boost_archive import RawFrame360
from rgbd360_torch.io.rawlog import Obs2DRangeScan, Obs3DRangeScan, read_rawlog

# LoadRawlog.cpp:72 — the 4 physical sensors fill the 8 rig slots
SENSOR_ARRANGEMENT = (3, 0, 2, 1, 3, 0, 2, 1)
NUM_SENSORS = 4  # :69


def ring_sensor_poses() -> list:
    """The hardcoded 45-degree ring seed poses (LoadRawlog.cpp:77-92):
    sensor 0 at [0.055, 0, 0], each next pose a 45-degree yaw (about +y in
    the x-z plane) of the previous."""
    pose0 = np.eye(4)
    pose0[0, 3] = 0.055
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    rt45 = np.eye(4)
    rt45[0, 0] = rt45[2, 2] = c
    rt45[0, 2] = s
    rt45[2, 0] = -s
    poses = [pose0]
    for _ in range(1, NUM_SENSORS):
        poses.append(rt45 @ poses[-1])
    return poses


def rgbd360_frames(path: str, decimation: int = 1):
    """Yield (frame_index, [4 x Obs3DRangeScan]) omnidirectional frames
    (grouping + decimation of LoadRawlog.cpp:199-238)."""
    pending = [None] * NUM_SENSORS
    emitted = 0
    for obs in read_rawlog(path):
        if isinstance(obs, Obs2DRangeScan):
            continue  # :219-222 captures LASER but never uses it
        if not isinstance(obs, Obs3DRangeScan):
            continue
        label = obs.sensor_label
        if label.startswith("RGBD"):
            idx = int(label[4:]) - 1
            if 0 <= idx < NUM_SENSORS:
                pending[idx] = obs
        if any(o is None for o in pending):
            continue
        group, pending = pending, [None] * NUM_SENSORS  # :233
        emitted += 1
        if emitted % decimation != 0:  # :235-238
            continue
        yield emitted - 1, group


def frame360_from_obs(calib, group, frame_id: int = 0, device=None) -> Frame360:
    """Fill a Frame360 on ``device`` from the 4 observations through
    SENSOR_ARRANGEMENT (LoadRawlog.cpp:245-284): rgb <- intensityImage,
    depth <- rangeImage metres converted to u16 mm. The depth is the
    sensor's registered range image: undistort() is the caller's."""
    rgbs, depths = [], []
    for slot in range(8):
        obs = group[SENSOR_ARRANGEMENT[slot]]
        rgb = obs.intensity_image
        if rgb is None:
            raise ValueError(f"{obs.sensor_label}: no intensity image")
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[..., None], 3, axis=-1)
        if obs.range_image is None:
            raise ValueError(f"{obs.sensor_label}: no range image")
        # convertTo(CV_16UC1, 1000) saturate_casts with round-to-nearest
        # (LoadRawlog.cpp:267-272) — rint before the cast, not truncation
        depth_mm = np.clip(np.rint(obs.range_image * 1000.0), 0, 65535).astype(np.uint16)
        rgbs.append(rgb)
        depths.append(depth_mm)
    frame = Frame360(calib, frame_id, device)
    frame.set_raw(RawFrame360(rgb=np.stack(rgbs), depth=np.stack(depths), timestamp=group[0].timestamp))
    return frame


def main(argv=None) -> int:
    from rgbd360_torch.utils.viz import save_ply, save_sphere_images

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("rawlog")
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", choices=("images", "cloud", "save"), default="images")
    ap.add_argument("--decimation", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames")
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    os.makedirs(args.out, exist_ok=True)

    count = 0
    for frame_no, group in rgbd360_frames(args.rawlog, args.decimation):
        frame = frame360_from_obs(calib, group, frame_no, args.device)
        frame.stitch_spherical_image()
        print(
            f"frame {frame_no}: timestamp {frame.timestamp} "
            f"depth coverage {float((frame.sphere_depth_mm.to(torch.int32) > 0).float().mean()):.3f}"
        )
        if args.mode == "images":
            save_sphere_images(frame, args.out, f"{frame_no:04d}")
        elif args.mode == "cloud":
            frame.undistort()
            xyz, rgb = frame.build_sphere_cloud()
            keep = np.isfinite(xyz).all(axis=1) & (np.abs(xyz) < 20).all(axis=1)
            save_ply(os.path.join(args.out, f"cloud_{frame_no:04d}.ply"), xyz[keep], rgb[keep])
        else:  # save: the mode-4 keyframe dump (:339)
            frame.undistort()
            frame.get_planes(need_inliers=False)
            frame.build_sphere_cloud_from_image()
            frame.save(args.out, frame_no)
        count += 1
        if args.max_frames and count >= args.max_frames:
            break
    print(f"processed {count} omnidirectional frames")
    return 0 if count else 1


if __name__ == "__main__":
    raise SystemExit(main())
