"""Check that a pair's registration does not depend on the other pairs of
its align_batch call, on one device.

  --compare (default): align_batch of 8 pairs (the golden pair, or the dry
      run's synthetic panorama at the smaller sizes, each pair from its own
      yawed seed) against the same pairs aligned in two halves, one by one,
      and in two threads on their own streams; prints, per case, which
      AlignResult fields are bit-equal and the largest pose difference.
  --trace: records the outputs of the aligner's functions in call order
      for the 8 pairs and for one of them alone, and prints the first call
      whose output for that pair differs in bits.

    python tools/batch_invariance.py [--device cuda] [--trace]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
import threading

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rgbd360_torch.ops import linalg6, photoicp, se3  # noqa: E402
from rgbd360_torch.parallel import dryrun  # noqa: E402
from rgbd360_torch.parallel.batch import align_batch  # noqa: E402

BATCH = 8
TRACED = ("build_pyramid_set", "sphere_xyz_lut", "pack_target_planes8", "_project_indices", "_warp_jacobian",
          "_residual_terms", "_pair_grams", "_exact_gather", "_kernel_coords", "_channels", "fused_sweep_sphere",
          "_huber_weight", "_transform", "_select", "_matmul_unrolled")


def golden_pairs(dev):
    golden = np.load(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "tests", "golden", "pair_1_10.npz"))
    stack = lambda a: torch.from_numpy(np.ascontiguousarray(np.broadcast_to(a, (BATCH,) + a.shape))).to(dev)
    return (stack(golden["gray_src_u8"].astype(np.float32) / 255.0), stack(golden["depth_src_mm"].astype(np.float32) * 0.001),
            stack(golden["gray_trg_u8"].astype(np.float32) / 255.0), stack(golden["depth_trg_mm"].astype(np.float32) * 0.001),
            dryrun.yawed_seeds(BATCH).to(dev))


def synthetic_pairs(h, w, dev):
    gray, depth = (x.to(dev) for x in dryrun.synthetic_pair(h, w, BATCH))
    return gray, depth, gray, depth, dryrun.yawed_seeds(BATCH).to(dev)


def same_fields(a, b) -> dict:
    out = {}
    for field in photoicp.AlignResult._fields:
        x, y = getattr(a, field), getattr(b, field)
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        out[field] = bool(torch.equal(x, y))
    return out


def cat(results):
    return photoicp.AlignResult(*[torch.cat([getattr(r, f) for r in results]) for f in photoicp.AlignResult._fields])


def compare(dev) -> None:
    cases = [("golden 320x1920", golden_pairs(dev), 5, False), ("golden 320x1920 full coverage", golden_pairs(dev), 3, True),
             ("synthetic 32x192", synthetic_pairs(32, 192, dev), 3, False),
             ("synthetic 160x960", synthetic_pairs(160, 960, dev), 2, False)]
    for name, args, levels, full in cases:
        run = lambda k0, k1: align_batch(*(a[k0:k1] for a in args), n_levels=levels, full_coverage=full)
        whole = run(0, BATCH)
        splits = {"halves": cat([run(0, 4), run(4, 8)]), "singles": cat([run(k, k + 1) for k in range(BATCH)])}
        results = {}

        def shard(k0):
            stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                results[k0] = run(k0, k0 + 4)
            if stream is not None:
                stream.synchronize()

        threads = [threading.Thread(target=shard, args=(k0,)) for k0 in (0, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        splits["threads"] = cat([results[0], results[4]])
        print(f"{name}, {levels} levels: iterations {whole.num_iterations.tolist()}", flush=True)
        for split, res in splits.items():
            diff = float((res.pose - whole.pose).abs().max())
            print(f"  {split}: bit-equal {same_fields(res, whole)}; max |pose diff| {diff}", flush=True)


def trace(dev) -> None:
    log = []

    def flat(x, out):
        if isinstance(x, torch.Tensor):
            out.append(x.detach().clone())
        elif isinstance(x, dict):
            for v in x.values():
                flat(v, out)
        elif isinstance(x, (tuple, list)):
            for v in x:
                flat(v, out)
        return out

    def wrap(mod, name):
        real = getattr(mod, name)

        @functools.wraps(real)
        def inner(*a, **k):
            result = real(*a, **k)
            log.append((name, flat(result, [])))
            return result

        setattr(mod, name, inner)
        return real

    wrapped = [(photoicp, n) for n in TRACED] + [(linalg6, "spd_well_posed"), (linalg6, "solve6_sym"), (se3, "exp_se3")]
    saved = [(mod, name, wrap(mod, name)) for mod, name in wrapped]
    try:
        for h, w, levels, pair in [(32, 192, 3, 7), (160, 960, 2, 5)]:
            args = synthetic_pairs(h, w, dev)
            log.clear()
            align_batch(*args, n_levels=levels)
            batch = list(log)
            log.clear()
            align_batch(*(a[pair:pair + 1] for a in args), n_levels=levels)
            alone = list(log)
            first = None
            for k, ((name, outs), (name1, outs1)) in enumerate(zip(batch, alone)):
                if name != name1:
                    first = f"none before call {k}, where the batch iterates on ({name} vs {name1})"
                    break
                for j, (a, b) in enumerate(zip(outs, outs1)):
                    if a.dim() == 0 or a.shape[0] != BATCH:
                        continue
                    a = a[pair:pair + 1].contiguous()
                    if a.dtype == torch.float32:
                        a, b = a.view(torch.int32), b.contiguous().view(torch.int32)
                    if not torch.equal(a, b):
                        first = f"call {k}: {name} output {j} differs"
                        break
                if first:
                    break
            print(f"{h}x{w}, {levels} levels, pair {pair} alone vs in the batch, {len(batch)} / {len(alone)} calls: "
                  f"first difference {first}", flush=True)
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from rgbd360_torch.kernels import build

        build.load_library()
    trace(dev) if args.trace else compare(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
