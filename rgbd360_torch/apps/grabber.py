"""RGBD360_Grabber — record an 8-sensor stream to reference-format
sphere_images_%d.bin files (reference Grabber/RGBD360_Grabber.cpp:83+).

Counterpart of rgbd360_tpu/apps/grabber.py. Host only (no --device): the
sources are --replay (an existing sequence) or --synthetic (procedural
frames), since there is no camera hardware.

Usage: python -m rgbd360_torch.apps.grabber --out DIR
       (--replay DATASET | --synthetic N) [--max-frames N]
"""

from __future__ import annotations

import argparse
import sys

from rgbd360_torch.io.grabber import Recorder, ReplaySource, SyntheticSource


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--replay", default=None)
    ap.add_argument("--synthetic", type=int, default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args(argv)

    if args.replay:
        source = ReplaySource(args.replay)
    elif args.synthetic is not None:
        source = SyntheticSource(args.synthetic)
    else:
        ap.error("choose a source: --replay DATASET or --synthetic N")
    n = Recorder(args.out).record(source, args.max_frames)
    print(f"recorded {n} frames -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
