"""Time and profile SphereGraphSLAM over the 40-frame loop on the card.

Writes the loop of tools/synthetic_rig.py (40 frames, one loop of radius
1.1 m) into a temporary directory, runs the port's SphereGraphSLAM app on
it once to warm up (the kernel and native-loader builds, the allocator),
then RUNS more times with stage timing off — each run's median and p90 ms
per frame after frame 5, the spread between runs — and once more with
torch.profiler recording PROFILED_FRAMES frames of the steady state: the
device's busy share there (the union of the CUDA kernel and copy intervals
over those frames' wall time), the device event count, and the kernels
that take the most device time. Prints the card's name and power limit
beside the numbers. Needs a CUDA device.

Usage: python tools/profile_slam_loop.py [--runs 2] [--frames 40]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rgbd360_torch.apps import sphere_graph_slam  # noqa: E402
from rgbd360_torch.device import require_cuda  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

WAIT_FRAMES = 20  # frames before the profiled window (the steady state, closures running)
PROFILED_FRAMES = 5


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_app(seq: str, calib_root: str, dev) -> tuple:
    """One run of the app; returns (per-frame ms, wall ms, loop closures)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        session = sphere_graph_slam.run([seq, "--calib-root", calib_root, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1000.0
    frame_ms = np.array([float(ms) for ms in re.findall(r"^frame \d+: .*\(([0-9.]+) ms\)$", buf.getvalue(), re.M)])
    return frame_ms, wall, session.n_loop_closures


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args(argv)
    dev = require_cuda()
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        calib_root, seq = os.path.join(tmp, "calib"), os.path.join(tmp, "seq")
        rig.write_sequence(seq, rig.write_calib_root(calib_root), frames=args.frames, loops=1.0, radius=1.1,
                           workers=min(8, os.cpu_count() or 1))
        _ms, warm_wall, _n = run_app(seq, calib_root, dev)
        print(f"[{card}] warm-up run: {warm_wall:.1f} ms", flush=True)
        medians = []
        for k in range(args.runs):
            frame_ms, wall, n_lc = run_app(seq, calib_root, dev)
            steady = frame_ms[5:]
            medians.append(float(np.median(steady)))
            print(f"[{card}] run {k + 1}: ms per frame after frame 5 median {np.median(steady):.3f}, p90 "
                  f"{np.percentile(steady, 90):.3f}; the app {wall:.1f} ms; {n_lc} loop closures", flush=True)
        print(f"[{card}] medians over {args.runs} runs: {np.round(medians, 3).tolist()} (spread "
              f"{max(medians) - min(medians):.3f} ms)", flush=True)

        # the profiler records PROFILED_FRAMES frames of the steady state
        # (from frame WAIT_FRAMES + 2 on): recording a whole run's host ops
        # takes minutes to process
        marks, found = [], {}
        real_pipeline = sphere_graph_slam.planes_pipeline

        def stepping(*a, **k):
            for item in real_pipeline(*a, **k):
                marks.append(time.perf_counter())  # before the step that may process the trace
                prof.step()
                yield item

        def collect(p):
            # the device's kernels, copies and sets; not the profiler's own
            # step annotations, which span the whole window on the device row
            found["events"] = [e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA
                               and not e.name.startswith("ProfilerStep")]

        schedule = torch.profiler.schedule(wait=WAIT_FRAMES, warmup=1, active=PROFILED_FRAMES, repeat=1)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        sphere_graph_slam.planes_pipeline = stepping
        try:
            with torch.profiler.profile(activities=activities, schedule=schedule, on_trace_ready=collect) as prof:
                frame_ms, _wall, _n = run_app(seq, calib_root, dev)
        finally:
            sphere_graph_slam.planes_pipeline = real_pipeline
    # the profiler's step n runs from the n-th frame's yield to the next: the
    # active steps WAIT_FRAMES+1 .. WAIT_FRAMES+PROFILED_FRAMES process the
    # frames (0-based) WAIT_FRAMES .. WAIT_FRAMES+PROFILED_FRAMES-1
    first = WAIT_FRAMES
    wall_us = (marks[first + PROFILED_FRAMES] - marks[first]) * 1e6
    device = found.get("events", [])
    busy_us = union_us([(e.time_range.start, e.time_range.end) for e in device])
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[{card}] profiled frames {first + 1}-{first + PROFILED_FRAMES}: wall {wall_us / 1000:.1f} ms "
          f"(the frames {np.round(frame_ms[first:first + PROFILED_FRAMES], 1).tolist()} ms under the profiler), device "
          f"busy {busy_us / 1000:.1f} ms = {busy_us / wall_us:.1%} of it, idle {1 - busy_us / wall_us:.1%}; "
          f"{len(device)} device events", flush=True)
    for name, us in top:
        print(f"  {us / 1000:9.1f} ms  {name[:110]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
