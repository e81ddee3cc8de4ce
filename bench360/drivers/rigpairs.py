"""Closed-loop batched robot-frame registration (RegisterDensePhotoICP)
through the program's align_batch_rig: pairs of raw 8-sensor frames, each
pair's sensors registered jointly through the rig's extrinsics.

Traffic parameters (bench360/workloads/<cell>.json):
  circle        {frames, deg_per_step, radius}: the rig's poses on the
                room's circle (lib/rig.py)
  pairs         "consecutive" or "loop_closure", as drivers/pairs.py
                (min_trajectory_gap_m, max_baseline_m for the latter)
  guess         "identity" (the odometry guess)
  batch         pairs per align_batch_rig call
  calibration_seed  the seed of the calibration root's CLAMS models (the
                robot-frame registration reads the raw depth: they go
                unused)
  warmup_batches, check_batches, trace_seconds, limits

The seed draws the order of the pairs as in drivers/pairs.py; the next
batch is sent once the previous batch's poses are on the host, and
pairs_per_s is the pairs of every batch sent in the window over the time
from the window's start to the last batch's read-back. A program without
align_batch_rig fails at once in setup().
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from bench360.drivers.pairs import PairStream, pair_pool
from bench360.lib import rig
from bench360.lib.compare import Worst, iter_gap, pose_gap, rel_gap
from bench360.lib.trace import DeviceTrace
from bench360.reference import api as reference
from bench360.reference import frames as ref_frames
from bench360.reference import pinhole as ref_pinhole


def guess_of(w: dict) -> np.ndarray:
    if w["guess"] != "identity":
        raise ValueError(f"unknown guess {w['guess']!r}")
    return np.eye(4, dtype=np.float32)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.w = ctx.workload
        self.records = []  # (pool indices, host results) per batch of the window

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from rgbd360_torch.core.frame360 import Frame360
        from rgbd360_torch.io.calib import Calib360
        from rgbd360_torch.ops.image import gray_f32
        from rgbd360_torch.parallel import batch as pbatch

        if not hasattr(pbatch, "align_batch_rig"):
            raise RuntimeError("the program has no rgbd360_torch.parallel.batch.align_batch_rig: "
                               "it cannot register batches of rig frames")
        self.align = pbatch.align_batch_rig
        ctx, w = self.ctx, self.w
        self.calib_root = os.path.join(ctx.tmp, "calib")
        seq = os.path.join(ctx.tmp, "seq")
        rts = rig.write_calib_root(self.calib_root, w["calibration_seed"])
        c = w["circle"]
        self.poses = rig.circle_poses(c["frames"], c["deg_per_step"], c["radius"])
        self.pool = pair_pool(w, self.poses)
        self.frames = sorted({i for p in self.pool for i in p})
        t0 = time.perf_counter()
        self.paths = dict(zip(self.frames, rig.write_captures(seq, self.poses, self.frames, rts, ctx.workers)))
        ctx.note(f"set-up: ray-cast {len(self.frames)} captures in {time.perf_counter() - t0:.3f} s "
                 f"({ctx.workers} processes); {len(self.pool)} pairs in the pool")

        calib = Calib360.load(self.calib_root)
        gray, depth = [], []
        for i in self.frames:
            f = Frame360(calib, i + 1, ctx.device)
            f.load_frame(self.paths[i])
            gray.append(gray_f32(f.rgb))
            depth.append(f.depth_raw_mm.to(torch.float32) * 0.001)
        self.cam_rts, _rt_inv, self.k = calib.device_extrinsic_arrays(ctx.device)
        slot = {i: k for k, i in enumerate(self.frames)}
        self.gray, self.depth = torch.stack(gray), torch.stack(depth)
        self.trg_idx = torch.tensor([slot[t] for t, _s in self.pool], device=ctx.device)
        self.src_idx = torch.tensor([slot[s] for _t, s in self.pool], device=ctx.device)
        self.guesses = torch.from_numpy(np.stack([guess_of(w)] * len(self.pool))).to(ctx.device)
        warm = PairStream(len(self.pool), w["batch"], ctx.seed + 1)
        for _ in range(w["warmup_batches"]):
            self._batch(warm.next())

    def _batch(self, idx: list):
        """One batch: assemble, align, read back. Returns the host results."""
        k = torch.tensor(idx, device=self.ctx.device)
        s, t = self.src_idx[k], self.trg_idx[k]
        res = self.align(self.gray[s], self.depth[s], self.gray[t], self.depth[t], self.cam_rts, self.k,
                         self.guesses[k])
        b = len(idx)
        flat = torch.cat([res.pose.reshape(b, 16), res.error[:, None], res.av_photo_residual[:, None],
                          res.av_depth_residual[:, None], res.ill_posed[:, None].to(torch.float32),
                          res.num_iterations.to(torch.float32)], dim=1).cpu().numpy()
        return {"pose": flat[:, :16].reshape(b, 4, 4), "error": flat[:, 16], "av_photo": flat[:, 17],
                "av_depth": flat[:, 18], "ill": flat[:, 19] != 0.0, "iters": flat[:, 20:].astype(np.int32)}

    # -- the window -----------------------------------------------------------
    def window(self) -> None:
        from rgbd360_torch.ops import photoicp_pinhole

        ctx = self.ctx
        stream = PairStream(len(self.pool), self.w["batch"], ctx.seed)
        trace = DeviceTrace(self.w["trace_seconds"]) if ctx.trace else None
        counts = {"rig_sweeps": 0, "rig_batches": 0, "rig_iterations": 0.0, "rig_align_s": 0.0}
        photoicp_pinhole.reset_sweep_counts()
        t_start = time.perf_counter()
        deadline = t_start + ctx.seconds
        t_end = t_start
        last = 0.0  # the last batch's time: the trace starts before the batch that would miss it
        while time.perf_counter() < deadline:
            if trace and trace.t0 is None and time.perf_counter() + last >= deadline - trace.seconds:
                counts["rig_sweeps"] = photoicp_pinhole.SWEEPS["sweeps"]
                t_a = time.perf_counter()
                trace.start()
                deadline += trace.t0 - t_a  # the profiler's start-up is no part of the trace
            idx = stream.next()
            t_a = time.perf_counter()
            out = self._batch(idx)
            t_end = time.perf_counter()
            last = t_end - t_a
            self.records.append((idx, out))
            ctx.attempted += len(idx)
            ctx.failed += int(np.sum(out["ill"] | ~np.isfinite(out["pose"]).all(axis=(1, 2))))
            if trace and trace.t0 is None:
                # the per-layer counts cover the untraced part of the window
                counts["rig_align_s"] += t_end - t_a
                counts["rig_iterations"] += float(out["iters"].max(axis=0).sum())
                counts["rig_batches"] += 1
                ctx.units += len(idx)
        if trace and trace.active:
            trace.stop()
        ctx.e2e["pairs_per_s"] = ctx.attempted / (t_end - t_start)
        ctx.note(f"window: {len(self.records)} batches, {ctx.attempted} pairs in {t_end - t_start:.3f} s")
        if trace and trace.t0 is not None:
            t0 = time.perf_counter()
            trace.digest()
            ctx.note(f"trace: {trace.window_s:.3f} s traced, digest {time.perf_counter() - t0:.1f} s")
            ctx.device_trace = trace
            ctx.counters = counts

    def release(self) -> None:
        del self.gray, self.depth, self.guesses, self.src_idx, self.trg_idx

    # -- correctness ----------------------------------------------------------
    def check(self, control: bool = False) -> list:
        """The plain reference (reference/pinhole.py), one pair at a time,
        over a seeded sample of the window's batches (the one with the most
        Gauss-Newton iterations among them), from the raw captures it reads
        itself: each pair's pose, its error and average photo and depth
        residuals, its ill-posed flag (a pair the two sides disagree on
        reads inf) and its Gauss-Newton iterations per level. ``control``:
        the reference one precision lower stands in the program's place."""
        ctx, w = self.ctx, self.w
        if not self.records:
            return []
        rng = np.random.default_rng(ctx.seed + 2)
        longest = max(range(len(self.records)), key=lambda k: self.records[k][1]["iters"].max(axis=0).sum())
        others = [k for k in range(len(self.records)) if k != longest]
        sample = [longest] + rng.choice(others, size=min(len(others), w["check_batches"] - 1), replace=False).tolist()
        inputs = {i: ref_pinhole.sensor_input(self.paths[i], ctx.device) for i in self.frames}
        rts = torch.from_numpy(ref_pinhole.extrinsics(self.calib_root)).to(ctx.device)
        cam = torch.from_numpy(ref_frames.camera_matrix()).to(ctx.device)
        limits = w["limits"]
        worst = Worst(*limits)
        for k in sample:
            idx, prog = self.records[k]
            for b, i in enumerate(idx):
                t, s = self.pool[i]
                args = (*inputs[s], *inputs[t], rts, cam, guess_of(w))
                ref = ref_pinhole.register(*args)
                got = {key: prog[key][b] for key in ("pose", "error", "av_photo", "av_depth", "ill", "iters")}
                if control:
                    with reference.precision(lower=True):
                        got = ref_pinhole.register(*args)
                if bool(got["ill"]) != bool(ref["ill"]):
                    worst.add("align_t_mm", float("inf"))
                t_mm, r_deg = pose_gap(got["pose"], ref["pose"])
                worst.add("align_t_mm", t_mm)
                worst.add("align_r_deg", r_deg)
                worst.add("align_iters", iter_gap(got["iters"], ref["iters"]))
                for key in ("error", "av_photo", "av_depth"):
                    worst.add("align_stats", rel_gap(got[key], ref[key]))
        return [(name, value, limits[name]) for name, value in worst.values.items()]
