"""Time the port's align_batch from two checkouts on one CUDA device, in
alternating processes.

Each round starts one process per checkout (the lead swapping every round:
A B, B A, ...); a process imports rgbd360_torch from its checkout, builds
its kernels, aligns the golden pair (tests/golden/pair_1_10.npz) at batch
8, 1920x320, 5 levels, PHOTO_DEPTH once to warm up, then times --aligns
more with CUDA events. The script prints each checkout's ms per batch per
round and their medians, each align's iteration signature and finest
error, and the card's name and power limit.

    python tools/align_ab_trees.py A_DIR B_DIR [--rounds 2] [--aligns 3]

A checkout is a directory holding rgbd360_torch/ and tests/golden/ (for
example a `git archive` of another commit, unpacked).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BATCH = 8
N_LEVELS = 5


def child(tree: str, aligns: int) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from rgbd360_torch.device import require_cuda
    from rgbd360_torch.kernels import build
    from rgbd360_torch.ops import photoicp
    from rgbd360_torch.parallel.batch import align_batch

    dev = require_cuda()
    build.load_library()
    golden = np.load(os.path.join(tree, "tests", "golden", "pair_1_10.npz"))
    stack = lambda a: torch.from_numpy(np.ascontiguousarray(np.broadcast_to(a, (BATCH,) + a.shape))).to(dev)
    args = (stack(golden["gray_src_u8"].astype(np.float32) / 255.0), stack(golden["depth_src_mm"].astype(np.float32) * 0.001),
            stack(golden["gray_trg_u8"].astype(np.float32) / 255.0), stack(golden["depth_trg_mm"].astype(np.float32) * 0.001),
            torch.eye(4, device=dev).expand(BATCH, 4, 4).contiguous())
    res = align_batch(*args, photoicp.PHOTO_DEPTH, N_LEVELS)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(aligns):
        align_batch(*args, photoicp.PHOTO_DEPTH, N_LEVELS)
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({"ms": start.elapsed_time(end) / aligns, "signature": res.num_iterations[0].tolist(),
                      "error": float(res.error[0])}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--aligns", type=int, default=3)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.aligns)
    if len(args.trees) != 2:
        ap.error("name two checkouts")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    samples = {tree: [] for tree in args.trees}
    for k in range(args.rounds):
        for tree in (args.trees if k % 2 == 0 else args.trees[::-1]):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree, "--aligns", str(args.aligns)],
                                 capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
            result = json.loads(out)
            samples[tree].append(result["ms"])
            print(f"round {k + 1} {tree}: {result['ms']:.3f} ms/batch, signature {result['signature']}, "
                  f"error {result['error']:.6f}", flush=True)
    for tree, ms in samples.items():
        ms_sorted = sorted(ms)
        median = (ms_sorted[(len(ms) - 1) // 2] + ms_sorted[len(ms) // 2]) / 2
        print(f"[{card}] {tree}: align_batch B={BATCH} 1920x320 {N_LEVELS} levels, median {median:.3f} ms/batch "
              f"over {len(ms)} processes of {args.aligns} aligns: {[round(x, 3) for x in ms]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
