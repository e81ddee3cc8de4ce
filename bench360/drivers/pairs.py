"""Closed-loop batched pair registration through the program's align_batch.

Traffic parameters (bench360/workloads/<cell>.json):
  circle        {frames, deg_per_step, radius}: the rig's poses on the
                room's circle (lib/rig.py); only the captures the pairs use
                are ray-cast
  pairs         "consecutive": (i, i + 1) for every i, target i, source
                i + 1; "loop_closure": every (i, j), j > i, that the loop
                closer's rule admits (at least min_trajectory_gap_m of
                trajectory between them) within max_baseline_m
  guess         "identity", or "ground_truth": the true relative pose in
                the sphere frame
  full_coverage the aligner's full-coverage (triple-anchored) sweeps
  batch         pairs per align_batch call
  calibration_seed  the seed of the calibration root's CLAMS models
  warmup_batches, check_batches, trace_seconds, limits

The seed draws the order of the pairs: batch after batch takes the next
``batch`` pairs of a stream of seeded permutations of the pool, so every
seed sends the same pairs; the calibration root's CLAMS models come from
the traffic's calibration_seed. The next batch is sent once the previous
batch's results are on the host. pairs_per_s is the pairs of every batch
sent in the window over the time from the window's start to the last
batch's read-back; no batch is sent after --seconds.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from bench360.lib import rig
from bench360.lib.compare import Worst, iter_gap, pose_gap, rel_gap
from bench360.lib.trace import DeviceTrace, gather_launches
from bench360.reference import api as reference
from bench360.reference.frames import Stitcher


def rot_offset() -> np.ndarray:
    """The 157.5 deg sphere-vs-rig frame offset (OdometryRGBD360.cpp:137-139)."""
    a = np.deg2rad(157.5)
    m = np.eye(4)
    m[1, 1] = m[2, 2] = np.cos(a)
    m[1, 2] = np.sin(a)
    m[2, 1] = -np.sin(a)
    return m


def pair_pool(w: dict, poses: np.ndarray) -> list:
    """[(target, source)] frame indices of the traffic's pairs."""
    n = len(poses)
    if w["pairs"] == "consecutive":
        return [(i, i + 1) for i in range(n - 1)]
    if w["pairs"] == "loop_closure":
        steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
        travelled = np.concatenate([[0.0], np.cumsum(steps)])
        return [(i, j) for i in range(n) for j in range(i + 1, n)
                if travelled[j] - travelled[i] >= w["min_trajectory_gap_m"]
                and np.linalg.norm(poses[j, :3, 3] - poses[i, :3, 3]) <= w["max_baseline_m"]]
    raise ValueError(f"unknown pairs {w['pairs']!r}")


def guess_of(w: dict, poses: np.ndarray, trg: int, src: int) -> np.ndarray:
    if w["guess"] == "identity":
        return np.eye(4, dtype=np.float32)
    if w["guess"] == "ground_truth":
        off = rot_offset()
        rel = np.linalg.inv(poses[trg]) @ poses[src]
        return (off @ rel @ np.linalg.inv(off)).astype(np.float32)
    raise ValueError(f"unknown guess {w['guess']!r}")


class PairStream:
    """Batches of pool indices: seeded permutations of the pool, back to back."""

    def __init__(self, n: int, batch: int, seed: int):
        self.n, self.batch = n, batch
        self.rng = np.random.default_rng(seed)
        self.queue = []

    def next(self) -> list:
        while len(self.queue) < self.batch:
            self.queue.extend(self.rng.permutation(self.n).tolist())
        out, self.queue = self.queue[:self.batch], self.queue[self.batch:]
        return out


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.w = ctx.workload
        self.records = []  # (pool indices, host results) per batch of the window

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from rgbd360_torch.core.frame360 import Frame360
        from rgbd360_torch.io.calib import Calib360

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
            f.stitch_spherical_image()
            gray.append(f.sphere_gray)
            depth.append(f.sphere_depth_mm.to(torch.float32) * 0.001)
        slot = {i: k for k, i in enumerate(self.frames)}
        self.gray, self.depth = torch.stack(gray), torch.stack(depth)
        self.trg_idx = torch.tensor([slot[t] for t, _s in self.pool], device=ctx.device)
        self.src_idx = torch.tensor([slot[s] for _t, s in self.pool], device=ctx.device)
        self.guesses = torch.from_numpy(np.stack([guess_of(w, self.poses, t, s) for t, s in self.pool])).to(ctx.device)
        warm = PairStream(len(self.pool), w["batch"], ctx.seed + 1)
        for _ in range(w["warmup_batches"]):
            self._batch(warm.next())

    def _batch(self, idx: list):
        """One batch: assemble, align, read back. Returns the host results."""
        from rgbd360_torch.parallel import batch as pbatch

        k = torch.tensor(idx, device=self.ctx.device)
        s, t = self.src_idx[k], self.trg_idx[k]
        res = pbatch.align_batch(self.gray[s], self.depth[s], self.gray[t], self.depth[t], self.guesses[k],
                                 full_coverage=self.w["full_coverage"])
        b = len(idx)
        flat = torch.cat([res.pose.reshape(b, 16), res.error[:, None], res.av_photo_residual[:, None],
                          res.av_depth_residual[:, None], res.sso[:, None], res.ill_posed[:, None].to(torch.float32),
                          res.num_iterations.to(torch.float32)], dim=1).cpu().numpy()
        return {"pose": flat[:, :16].reshape(b, 4, 4), "error": flat[:, 16], "av_photo": flat[:, 17],
                "av_depth": flat[:, 18], "sso": flat[:, 19], "ill": flat[:, 20] != 0.0,
                "iters": flat[:, 21:].astype(np.int32)}

    # -- the window -----------------------------------------------------------
    def window(self) -> None:
        from rgbd360_torch.ops import photoicp

        ctx = self.ctx
        stream = PairStream(len(self.pool), self.w["batch"], ctx.seed)
        trace = DeviceTrace(self.w["trace_seconds"]) if ctx.trace else None
        counts = {"sweeps": 0, "gn_iterations": 0.0, "align_s": 0.0}
        photoicp.reset_sweep_counts()
        with gather_launches(trace) if trace else contextlib.nullcontext():
            t_start = time.perf_counter()
            deadline = t_start + ctx.seconds
            t_end = t_start
            last = 0.0  # the last batch's time: the trace starts before the batch that would miss it
            while time.perf_counter() < deadline:
                if trace and trace.t0 is None and time.perf_counter() + last >= deadline - trace.seconds:
                    counts["sweeps"] = sum(photoicp.SWEEPS.values())
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
                    counts["align_s"] += t_end - t_a
                    counts["gn_iterations"] += float(out["iters"].max(axis=0).sum())
                    ctx.units += len(idx)
            if trace and trace.active:
                trace.stop()
        ctx.e2e["pairs_per_s"] = ctx.attempted / (t_end - t_start)
        ctx.note(f"window: {len(self.records)} batches, {ctx.attempted} pairs in {t_end - t_start:.3f} s")
        if trace and trace.t0 is not None:
            t0 = time.perf_counter()
            trace.digest()
            ctx.note(f"trace: {trace.window_s:.3f} s traced, {len(trace.launches)} gather launches, "
                     f"digest {time.perf_counter() - t0:.1f} s")
            ctx.device_trace = trace
            ctx.counters = counts

    def release(self) -> None:
        del self.gray, self.depth, self.guesses, self.src_idx, self.trg_idx

    # -- correctness ----------------------------------------------------------
    def check(self, control: bool = False) -> list:
        """The reference over a seeded sample of the window's batches (the
        one with the most Gauss-Newton iterations among them), at the
        window's batch, from panoramas it stitches itself: each pair's pose,
        its statistics, its ill-posed flag (a pair the two sides disagree on
        reads inf) and its Gauss-Newton iterations per level. ``control``:
        the reference one precision lower stands in the program's place."""
        ctx, w = self.ctx, self.w
        if not self.records:
            return []
        rng = np.random.default_rng(ctx.seed + 2)
        longest = max(range(len(self.records)), key=lambda k: self.records[k][1]["iters"].max(axis=0).sum())
        others = [k for k in range(len(self.records)) if k != longest]
        sample = [longest] + rng.choice(others, size=min(len(others), w["check_batches"] - 1), replace=False).tolist()
        stitcher = Stitcher(self.calib_root, ctx.device)
        inputs = {i: stitcher.aligner_input(self.paths[i]) for i in self.frames}
        limits = w["limits"]
        worst = Worst(*limits)
        for k in sample:
            idx, prog = self.records[k]
            pairs = [self.pool[i] for i in idx]
            stack = lambda which, part: torch.stack([inputs[p[which]][part] for p in pairs])
            args = (stack(1, 0), stack(1, 1), stack(0, 0), stack(0, 1),
                    np.stack([guess_of(w, self.poses, t, s) for t, s in pairs]))
            ref = reference.align(*args, full_coverage=w["full_coverage"])
            if control:
                with reference.precision(lower=True):
                    prog = reference.align(*args, full_coverage=w["full_coverage"])
            for b in range(len(idx)):
                if bool(prog["ill"][b]) != bool(ref["ill"][b]):
                    worst.add("align_t_mm", float("inf"))
                t_mm, r_deg = pose_gap(prog["pose"][b], ref["pose"][b])
                worst.add("align_t_mm", t_mm)
                worst.add("align_r_deg", r_deg)
                worst.add("align_iters", iter_gap(prog["iters"][b], ref["iters"][b]))
                for key in ("error", "av_photo", "av_depth", "sso"):
                    worst.add("align_stats", rel_gap(prog[key][b], ref[key][b]))
        return [(name, value, limits[name]) for name, value in worst.values.items()]
