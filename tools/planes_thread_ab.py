"""Time the port's odometry app with --with-planes on a CUDA device, with
planes_pipeline's worker thread on and off, in alternating rounds.

The app fits each frame's planes through core/plane_extraction.planes_pipeline.
With ``threaded=True`` the collect and the host fit of a frame run on a
worker thread while the caller's thread goes on with the next pair; with
``threaded=False`` they run on the caller's thread, after the next frame's
device program is dispatched. Both give the same planes and trajectory (the
script checks it). Each round runs the app once per setting, the lead
swapping every round; the script prints, per setting, the whole app's wall
time and the per-frame medians of the align and the host fit (synchronised
stage brackets), and the card's name and power limit.

    python tools/planes_thread_ab.py [--rounds 4] [--frames 6]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--frames", type=int, default=6)
    args = ap.parse_args(argv)

    import torch

    from rgbd360_torch.apps import odometry
    from rgbd360_torch.core import plane_extraction
    from rgbd360_torch.device import require_cuda
    from rgbd360_torch.utils import timing
    from tools import synthetic_rig as rig

    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    samples = {True: [], False: []}
    trajectories = {}
    with tempfile.TemporaryDirectory() as tmp:
        calib_root, seq = os.path.join(tmp, "calib"), os.path.join(tmp, "seq")
        rig.write_sequence(seq, rig.write_calib_root(calib_root), frames=args.frames)
        # one unrecorded run builds the native loader and warms the caches
        with contextlib.redirect_stdout(io.StringIO()):
            odometry.main([seq, "--calib-root", calib_root, "--with-planes", "--device", str(dev)])
        try:
            for k in range(args.rounds):
                for threaded in ((True, False) if k % 2 == 0 else (False, True)):
                    odometry.planes_pipeline = functools.partial(plane_extraction.planes_pipeline, threaded=threaded)
                    out, buf = os.path.join(tmp, f"out_{threaded}_{k}"), io.StringIO()
                    timing.stage_timing(True)
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(buf):
                        rc = odometry.main([seq, "--calib-root", calib_root, "--out", out, "--with-planes",
                                            "--device", str(dev)])
                    torch.cuda.synchronize()
                    app_ms = (time.perf_counter() - t0) * 1000.0
                    timing.stage_timing(False)
                    if rc != 0:
                        raise AssertionError(f"the app failed (threaded={threaded})")
                    text = buf.getvalue()
                    stage = lambda name: np.median([float(v) for v in re.findall(rf"^{re.escape(name)} took ([0-9.]+) ms$", text, re.M)])
                    samples[threaded].append({"app_ms": app_ms, "align_ms": stage("Dense alignment 360"),
                                              "host_fit_ms": stage("planes host fit")})
                    trajectories.setdefault(threaded, np.loadtxt(os.path.join(out, "trajectory.txt")))
        finally:
            odometry.planes_pipeline = plane_extraction.planes_pipeline
            timing.stage_timing(False)
    if not np.array_equal(trajectories[True], trajectories[False]):
        raise AssertionError("the trajectories differ between the two settings")
    print(f"card: {card}")
    for threaded, rows in samples.items():
        med = {key: float(np.median([r[key] for r in rows])) for key in rows[0]}
        print(json.dumps({"threaded": threaded, "rounds": args.rounds, "frames": args.frames, "median": med,
                          "samples": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
