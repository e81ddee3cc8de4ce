"""LabelizeFrame360 / LabelizeSequence — annotate planes with semantic labels
and propagate them along a registered sequence (reference Labelization/).

Counterpart of rgbd360_tpu/apps/labelize.py. The frames' planes come from
the device program on --device (the card unless named); labels and their
propagation are host work.

Usage:
  python -m rgbd360_torch.apps.labelize <dataset_dir> --labels "0=wall,3=floor"
         [--first 1] [--sample 1] [--out DIR] [--calib-root DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from rgbd360_torch.apps.common import default_matcher_config, load_calib, sequence_files
from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.core.labelization import labelize_frame, propagate_labels
from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset")
    ap.add_argument("--labels", required=True, help="id=label[,id=label...] for the first frame")
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--sample", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--calib-root", default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the frames")
    args = ap.parse_args(argv)

    labels = {}
    for part in args.labels.split(","):
        k, _, v = part.partition("=")
        labels[int(k)] = v.strip()

    calib = load_calib(args.calib_root)
    registerer = RegisterRGBD360(default_matcher_config(args.calib_root))
    prev = None
    results = {}
    for frame_no, path in sequence_files(args.dataset, args.first, args.sample):
        frame = Frame360(calib, frame_no, args.device).build(path)
        frame.get_planes()
        if prev is None:
            n = labelize_frame(frame, labels)
            print(f"frame {frame_no}: {n} planes labeled")
        else:
            n = propagate_labels(prev, frame, registerer)
            print(f"frame {frame_no}: {n} labels propagated")
        results[frame_no] = {
            p.id: p.label for p in frame.planes.planes if p.label
        }
        prev = frame

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "labels.json"), "w") as f:
            json.dump(results, f, indent=1)
        print(f"labels -> {args.out}/labels.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
