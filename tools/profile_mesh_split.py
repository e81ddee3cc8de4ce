"""Where the time of a split batch goes: the golden pair at batch 8
(1920x320, 5 levels, PHOTO_DEPTH) on one CUDA device, aligned

  * unsplit: align_batch over the 8 pairs;
  * one shard: parallel/mesh.py over [dev] (one thread, one stream);
  * two threads: parallel/mesh.py over [dev, dev] (two shards of 4, each
    in its own thread on its own stream);
  * two in turn: align_batch over pairs 0-3, then over pairs 4-7, on the
    caller's thread;

in alternating rounds (the order reversed every round), each timed with
CUDA events over --aligns calls after one warm-up call. Prints ms per batch
per setting and round, the medians, and the card's name and power limit.

    python tools/profile_mesh_split.py [--rounds 2] [--aligns 3]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rgbd360_torch.device import require_cuda  # noqa: E402
from rgbd360_torch.kernels import build  # noqa: E402
from rgbd360_torch.ops import photoicp  # noqa: E402
from rgbd360_torch.parallel import mesh as pmesh  # noqa: E402
from rgbd360_torch.parallel.batch import align_batch  # noqa: E402

BATCH = 8
N_LEVELS = 5


def cuda_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--aligns", type=int, default=3)
    args = ap.parse_args(argv)
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.load_library()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    golden = np.load(os.path.join(root, "tests", "golden", "pair_1_10.npz"))
    stack = lambda a: torch.from_numpy(np.ascontiguousarray(np.broadcast_to(a, (BATCH,) + a.shape))).to(dev)
    ops = (stack(golden["gray_src_u8"].astype(np.float32) / 255.0), stack(golden["depth_src_mm"].astype(np.float32) * 0.001),
           stack(golden["gray_trg_u8"].astype(np.float32) / 255.0), stack(golden["depth_trg_mm"].astype(np.float32) * 0.001),
           torch.eye(4, device=dev).expand(BATCH, 4, 4).contiguous())
    half = BATCH // 2
    settings = {
        "unsplit": lambda: align_batch(*ops, photoicp.PHOTO_DEPTH, N_LEVELS),
        "one shard": lambda: pmesh.align_batch_sharded([dev], *ops, photoicp.PHOTO_DEPTH, N_LEVELS),
        "two threads": lambda: pmesh.align_batch_sharded([dev, dev], *ops, photoicp.PHOTO_DEPTH, N_LEVELS),
        "two in turn": lambda: [align_batch(*(x[k:k + half] for x in ops), photoicp.PHOTO_DEPTH, N_LEVELS)
                                for k in (0, half)],
    }
    samples = {name: [] for name in settings}
    for k in range(args.rounds):
        for name in (list(settings) if k % 2 == 0 else list(settings)[::-1]):
            samples[name].append(cuda_ms(settings[name], args.aligns))
            print(f"round {k + 1} {name}: {samples[name][-1]:.3f} ms/batch", flush=True)
    print(f"[{card}] golden align B={BATCH} 1920x320 {N_LEVELS} levels, median of {args.rounds} alternating rounds "
          f"of {args.aligns}: " + "; ".join(f"{name} {np.median(ms):.3f} ms/batch" for name, ms in samples.items()),
          flush=True)
    print(json.dumps(samples), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
