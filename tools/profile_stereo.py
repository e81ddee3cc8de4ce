"""Time and profile the stereo plane program (core/frame360_stereo.py) on
the card at the full 1024 x 180, on the room ray-cast in the stereo
convention (tools/synthetic_rig.py). Needs a CUDA device:

    python tools/profile_stereo.py [--rounds 10]

Prints the card's name and power limit, then, warm and by CUDA events over
``rounds`` calls: each stage of the program (normals, segmentation,
refinement, per-label statistics) alone and the whole program; the host fit
of get_planes_stereo; and, under torch.profiler over ``rounds`` calls of the
program, the device's busy time (the sum of the kernels' own times) against
the wall time, and the kernels that take most of it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line, cuda_ms  # noqa: E402
from rgbd360_torch.core import frame360_stereo as st  # noqa: E402
from rgbd360_torch.device import require_cuda  # noqa: E402
from rgbd360_torch.ops import normals, plane_stats, planes_seg  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402
from bench360.lib.trace import union_us  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    dev = require_cuda()
    card = card_line()
    print(f"card: {card}", flush=True)

    rgb_np, depth = rig.raycast_room_stereo(rig.stereo_pose())
    frame = st.Frame360Stereo(device=dev)
    # Frame360Stereo.load_depth / load_rgb, without the files
    frame.sphere_depth_mm = torch.from_numpy(np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)).to(dev)
    frame.sphere_rgb = rgb = torch.from_numpy(rgb_np).to(dev)
    depth_m = frame.depth_m()
    xyz = st.stereo_cloud(depth_m)[None]
    n = normals.organized_normals(xyz, max_depth_change=0.05)
    pre = planes_seg.segment_planes(xyz, n, angular_threshold=0.05, distance_threshold=0.05)
    lab = planes_seg.refine_plane_labels(pre, xyz, n, distance_threshold=0.05, min_inliers=st.MIN_INLIERS_STEREO)
    stages = {
        "cloud": lambda: st.stereo_cloud(depth_m),
        "normals": lambda: normals.organized_normals(xyz, max_depth_change=0.05),
        "segment": lambda: planes_seg.segment_planes(xyz, n, angular_threshold=0.05, distance_threshold=0.05),
        "refine": lambda: planes_seg.refine_plane_labels(pre, xyz, n, distance_threshold=0.05,
                                                         min_inliers=st.MIN_INLIERS_STEREO),
        "stats": lambda: plane_stats.sensor_plane_stats(xyz, rgb[None], lab, pre),
        "the whole program": lambda: st.stereo_plane_stats(depth_m, rgb),
    }
    ms = {name: cuda_ms(fn, args.rounds) for name, fn in stages.items()}
    print(f"[{card}] stereo program 1024 x 180, ms warm (CUDA events, mean of {args.rounds}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)

    frame.get_planes_stereo()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        frame.get_planes_stereo()
    planes_ms = (time.perf_counter() - t0) * 1000.0 / args.rounds
    print(f"[{card}] get_planes_stereo {planes_ms:.3f} ms per call ({len(frame.planes)} planes): the host fit and "
          f"the copies ~{planes_ms - ms['the whole program']:.3f} ms beyond the device program", flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.rounds):
            st.stereo_plane_stats(depth_m, rgb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    # the device's kernels, copies and sets (bench360/lib/trace.py)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = union_us([(e.time_range.start, e.time_range.end) for e in device]) / 1000.0
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1000.0
    print(f"[{card}] under the profiler, {args.rounds} calls: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({busy_ms / wall_ms:.1%}), {len(device)} device events; the largest by device time:", flush=True)
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {t:9.3f} ms  {name[:110]}", flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
