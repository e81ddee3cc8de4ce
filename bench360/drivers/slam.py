"""Sessions of the program's SphereGraphSLAM app, back to back.

Traffic parameters (bench360/workloads/<cell>.json):
  circle        {frames, deg_per_step, radius}: the rig's poses on the
                room's circle (lib/rig.py)
  use_frames    the dataset is the circle's first use_frames captures
  calibration_seed  the seed of the calibration root's CLAMS models
  warmup_frames a session over this many captures warms up set-up
  trace_seconds, check {frames, tracking, loop_closure}
  expect        what each whole session makes: {keyframes, planes,
                loop_closures, lc_batched}, as sound runs read them
  limits        the limit of each number the check compares (ate_mm: the
                trajectory's ATE, where a fault separates it)

The window drives the program's own ``sphere_graph_slam.run`` over the
dataset, one session after another. Its frame source (the app's
``planes_pipeline``) is wrapped so that no new frame starts once --seconds
have passed: the frame in progress finishes and its session ends. A
frame's time runs from the completion of the previous frame of its session
(its pose on the host) to its own; a session's first frame is timed from
the session's start, so session set-up is counted. The dataset and its
calibration root (CLAMS models from the traffic's calibration_seed) are
fixed, so every seed has the same work: the CLAMS models move the planes,
and with them the loop closer's candidates. The seed draws the sample the
correctness check compares.

Correctness has two parts. Step by step, the reference stitches a sample
of the window's panoramas from the raw captures, re-runs a sample of the
tracking and loop-closure aligns from its own panoramas with the seeds
(PbMap guesses) the program used, and re-optimizes a pose graph from the
vertices and edges the program held. Over each session that ran the whole
dataset, what the program chose to do is held to what sound runs do: its
keyframes, planes, loop closures and batched loop-closure closures, each
count exactly (``expect``), and its final (optimized) trajectory against
the ground truth of the circle (ATE, mm). A window with no whole session
reads inf on those.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from bench360.lib import rig
from bench360.lib.compare import Worst, absolute_trajectory_error, iter_gap, pose_gap
from bench360.lib.trace import DeviceTrace, StageLines
from bench360.reference import api as reference
from bench360.reference.frames import Stitcher
from bench360.reference.image import gray_f32


class Recorder:
    """What the program's timed path produced, recorded as it runs: each
    session's frames (number and panorama), each dense align with its seed
    and result, each batched loop-closure refinement, each pose-graph
    optimization's state before and after."""

    def __init__(self):
        self.frames = []  # (frame_no, sphere_rgb, sphere_depth_mm)
        self.aligns = []  # dicts: full_coverage, src, trg, guess, host result
        self.batches = []  # dicts: src, trgs, guesses, results by candidate
        self.graphs = []  # dicts: vertices, edges, robust, args, after
        self.sessions = []  # dicts: what each whole session chose (Driver.summary)
        self.on = False

    @contextlib.contextmanager
    def installed(self):
        """Wrap the program's classes for the window."""
        from rgbd360_torch.core.graph_optimizer import GraphOptimizer
        from rgbd360_torch.core.loop_closure import LoopClosure360
        from rgbd360_torch.core.register_photoicp import RegisterPhotoICP

        rec = self
        real = (RegisterPhotoICP.set_source_frame, RegisterPhotoICP.set_target_frame,
                RegisterPhotoICP.align_frames360, LoopClosure360._refine_batch, GraphOptimizer.optimize_graph)

        def set_source(self, rgb, depth):
            self._bench_src = rgb
            return real[0](self, rgb, depth)

        def set_target(self, rgb, depth):
            self._bench_trg = rgb
            return real[1](self, rgb, depth)

        def align(self, pose_guess=None, method=0, occlusion=0, full_coverage=False):
            out = real[2](self, pose_guess, method, occlusion, full_coverage)
            if rec.on:
                guess = np.eye(4) if pose_guess is None else pose_guess
                rec.aligns.append({"full_coverage": full_coverage, "src": self._bench_src, "trg": self._bench_trg,
                                   "guess": np.asarray(guess, np.float32), "method": method, "occlusion": occlusion,
                                   "result": dict(self._fetch())})
            return out

        def refine(self, new_kf, survivors):
            out = real[3](self, new_kf, survivors)
            if rec.on:
                rec.batches.append({"src": new_kf.sphere_rgb, "trgs": [self.map.frames[c].sphere_rgb for c, _g in survivors],
                                    "guesses": [np.asarray(g, np.float32) for _c, g in survivors],
                                    "results": {c: (pose, av, None) for c, pose, av, _h, _s in out},
                                    "cands": [c for c, _g in survivors]})
            return out

        def optimize(self, iterations=10, lam=1e-6):
            before = [v.copy() for v in self.vertices]
            edges = [(e.i, e.j, e.z.copy(), e.info.copy()) for e in self.edges]
            out = real[4](self, iterations, lam)
            if rec.on:
                rec.graphs.append({"vertices": before, "edges": edges, "robust": self.robust,
                                   "args": (iterations, lam), "after": [v.copy() for v in self.vertices]})
            return out

        (RegisterPhotoICP.set_source_frame, RegisterPhotoICP.set_target_frame, RegisterPhotoICP.align_frames360,
         LoopClosure360._refine_batch, GraphOptimizer.optimize_graph) = (set_source, set_target, align, refine, optimize)
        try:
            yield
        finally:
            (RegisterPhotoICP.set_source_frame, RegisterPhotoICP.set_target_frame, RegisterPhotoICP.align_frames360,
             LoopClosure360._refine_batch, GraphOptimizer.optimize_graph) = real


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.w = ctx.workload
        self.rec = Recorder()
        self.frame_ms = []
        self.completed = 0  # frames finished in the window

    def _check_config(self) -> None:
        """The program runs as the configuration states, or the run stops."""
        from rgbd360_torch.apps import sphere_graph_slam
        from rgbd360_torch.core import loop_closure

        cfg = self.ctx.config
        found = {"track_back_keyframes": sphere_graph_slam.TRACK_BACK_KFS,
                 "min_trajectory_gap_m": loop_closure.MIN_TRAJECTORY_GAP,
                 "max_depth_residual": loop_closure.MAX_DEPTH_RESIDUAL}
        for key, value in found.items():
            if value != cfg[key]:
                raise RuntimeError(f"the program's {key} is {value}, the configuration states {cfg[key]}")

    def setup(self) -> None:
        from rgbd360_torch.parallel import batch as pbatch

        ctx, w = self.ctx, self.w
        self._check_config()
        self.calib_root = os.path.join(ctx.tmp, "calib")
        self.seq = os.path.join(ctx.tmp, "seq")
        rts = rig.write_calib_root(self.calib_root, w["calibration_seed"])
        c = w["circle"]
        poses = rig.circle_poses(c["frames"], c["deg_per_step"], c["radius"])
        self.truth = poses[:w["use_frames"]]
        t0 = time.perf_counter()
        rig.write_captures(self.seq, poses, range(w["use_frames"]), rts, ctx.workers)
        ctx.note(f"set-up: ray-cast {w['use_frames']} captures in {time.perf_counter() - t0:.3f} s "
                 f"({ctx.workers} processes)")
        warm = os.path.join(ctx.tmp, "warm")
        os.makedirs(warm)
        for i in range(w["warmup_frames"]):
            name = f"sphere_images_{i + 1}.bin"
            os.symlink(os.path.join(self.seq, name), os.path.join(warm, name))
        t0 = time.perf_counter()
        self.deadline = float("inf")
        session, _times = self._session(warm)
        # the loop closer's batched full-coverage refinement, which the warm
        # session is too short to reach
        kfs = session.world.frames[:2]
        metres = lambda f: f.sphere_depth_mm.to(torch.float32) * 0.001
        pbatch.align_batch(torch.stack([kfs[1].sphere_gray, kfs[0].sphere_gray]),
                           torch.stack([metres(kfs[1]), metres(kfs[0])]),
                           torch.stack([kfs[0].sphere_gray, kfs[1].sphere_gray]),
                           torch.stack([metres(kfs[0]), metres(kfs[1])]),
                           torch.eye(4, device=ctx.device).expand(2, 4, 4).contiguous(), full_coverage=True)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        ctx.note(f"set-up: warm-up session of {w['warmup_frames']} frames in {time.perf_counter() - t0:.3f} s")

    def _session(self, dataset: str, sink=None, on_frame=None):
        """One run() of the app; returns (session, completion times of its
        frames). No frame starts after ``self.deadline``; ``on_frame`` is
        called after each frame."""
        from rgbd360_torch.apps import sphere_graph_slam

        real = sphere_graph_slam.planes_pipeline
        times, rec = [], self.rec

        def gated(frames_iter, *a, **k):
            gen = real(frames_iter, *a, **k)
            try:
                for frame_no, frame in gen:
                    if rec.on:
                        rec.frames.append((frame_no, frame.sphere_rgb, frame.sphere_depth_mm))
                    yield frame_no, frame
                    times.append(time.perf_counter())
                    if on_frame is not None:
                        on_frame()
                    if time.perf_counter() >= self.deadline:
                        return
            finally:
                gen.close()

        sphere_graph_slam.planes_pipeline = gated
        try:
            with contextlib.redirect_stdout(sink or StageLines()):
                session = sphere_graph_slam.run([dataset, "--calib-root", self.calib_root,
                                                 "--device", str(self.ctx.device)])
        finally:
            sphere_graph_slam.planes_pipeline = real
        return session, times

    def window(self) -> None:
        from rgbd360_torch.utils import timing

        ctx = self.ctx
        trace = DeviceTrace(self.w["trace_seconds"]) if ctx.trace else None
        sink = StageLines()
        sessions = 0
        t_start = time.perf_counter()
        self.deadline = t_start + ctx.seconds

        last = [time.perf_counter(), 0.0]  # the last frame's end and time

        def on_frame():
            self.completed += 1
            now = time.perf_counter()
            last[:] = now, now - last[0]
            # the trace starts before the frame that would miss it
            if trace and trace.t0 is None and now + last[1] >= self.deadline - trace.seconds:
                # the per-layer spans cover the untraced part of the window
                ctx.stages = {k: v[0] for k, v in timing.timing_summary().items()}
                ctx.units = self.completed
                t_a = time.perf_counter()
                trace.start()
                self.deadline += trace.t0 - t_a  # the profiler's start-up is no part of the trace

        with self.rec.installed():
            self.rec.on = True
            if trace:
                timing.reset_timing()
                timing.stage_timing(True)
            while time.perf_counter() < self.deadline:
                t_session = time.perf_counter()
                session, times = self._session(self.seq, sink, on_frame)
                sessions += 1
                if len(times) == self.w["use_frames"]:
                    self.rec.sessions.append(self.summary(session))
                starts = [t_session] + times[:-1]
                self.frame_ms.extend((b - a) * 1000.0 for a, b in zip(starts, times))
                ctx.attempted += len(times)
                ctx.failed += len(times) - len(session.world)
                del session
            self.rec.on = False
            if trace:
                if trace.active:
                    trace.stop()
                timing.stage_timing(False)
                timing.reset_timing()
        ctx.e2e["frame_ms_p50"] = float(np.percentile(self.frame_ms, 50))
        ctx.e2e["frame_ms_p90"] = float(np.percentile(self.frame_ms, 90))
        ctx.note(f"window: {sessions} sessions, {len(self.frame_ms)} frames in "
                 f"{time.perf_counter() - t_start:.3f} s; {len(self.rec.batches)} batched refinements "
                 f"(pairs {[len(b['cands']) for b in self.rec.batches]}), {len(self.rec.graphs)} graph optimizations; "
                 f"whole sessions {self.rec.sessions}")
        if trace and trace.t0 is not None:
            t0 = time.perf_counter()
            trace.host_spans = sink.spans
            trace.digest()
            ctx.note(f"trace: {trace.window_s:.3f} s traced, digest {time.perf_counter() - t0:.1f} s")
            ctx.device_trace = trace

    def summary(self, session) -> dict:
        """What one whole session of the app chose: its counts, and the ATE
        (mm) of its final trajectory, the optimized keyframe poses, against
        the circle's ground truth (inf where a frame made no keyframe)."""
        world, lc = session.world, session.loop_closer
        poses = world.optimized_poses
        ate = (absolute_trajectory_error(poses, self.truth) * 1000.0 if len(poses) == len(self.truth)
               else float("inf"))
        return {"keyframes": len(world),
                "planes": sum(len(f.planes) for f in world.frames if f.planes is not None),
                "loop_closures": session.n_loop_closures,
                "lc_batched": sum(1 for _c, _k, batched in lc.accepted if batched),
                "ate_mm": ate}

    def release(self) -> None:
        pass

    def check(self, control: bool = False) -> list:
        """The reference on a seeded sample of what the window produced (the
        largest batched refinement and the largest graph among it).
        ``control``: the reference one precision lower stands in the
        program's place for the aligns and the graph."""
        ctx, w, rec = self.ctx, self.w, self.rec
        if not rec.frames:
            return []
        rng = np.random.default_rng(ctx.seed + 2)
        pick = lambda n, k: sorted(rng.choice(n, size=min(n, k), replace=False).tolist())
        number = {id(rgb): no for no, rgb, _d in rec.frames}
        cache = {}

        def ref_input(no):
            if not cache:
                cache["stitcher"] = Stitcher(self.calib_root, ctx.device)
            if no not in cache:
                cache[no] = cache["stitcher"].panorama(os.path.join(self.seq, f"sphere_images_{no}.bin"))
            rgb, depth_mm = cache[no]
            return gray_f32(rgb), depth_mm.to(torch.float32) * 0.001

        limits = w["limits"]
        worst = Worst(*limits)
        for s in rec.sessions:
            for key, value in w["expect"].items():
                worst.add(key, abs(s[key] - value))
            worst.add("ate_mm", s["ate_mm"])
        for k in pick(len(rec.frames), w["check"]["frames"]):
            no, rgb, depth = rec.frames[k]
            ref_input(no)
            r_rgb, r_depth = cache[no]
            worst.add("pano_px", float(((rgb != r_rgb).any(-1) | (depth != r_depth)).sum()))

        def compare_aligns(jobs, full_coverage):
            """jobs: (src no, [trg no], [guess], [program (pose, av_depth,
            iterations or None) or None])."""
            for src, trgs, guesses, progs in jobs:
                s = ref_input(src)
                ins = [ref_input(t) for t in trgs]
                b = len(trgs)
                args = (s[0][None].expand(b, -1, -1).contiguous(), s[1][None].expand(b, -1, -1).contiguous(),
                        torch.stack([x[0] for x in ins]), torch.stack([x[1] for x in ins]), np.stack(guesses))
                ref = reference.align(*args, full_coverage=full_coverage)
                if control:
                    with reference.precision(lower=True):
                        low = reference.align(*args, full_coverage=full_coverage)
                    progs = [None if low["ill"][i] else (low["pose"][i], low["av_depth"][i], low["iters"][i])
                             for i in range(b)]
                for i, prog in enumerate(progs):
                    if (prog is None) != bool(ref["ill"][i]):
                        worst.add("align_t_mm", float("inf"))
                        continue
                    if prog is None:
                        continue
                    t_mm, r_deg = pose_gap(prog[0], ref["pose"][i])
                    worst.add("align_t_mm", t_mm)
                    worst.add("align_r_deg", r_deg)
                    worst.add("align_avdepth", abs(float(prog[1]) - float(ref["av_depth"][i])))
                    if prog[2] is not None:
                        worst.add("align_iters", iter_gap(prog[2], ref["iters"][i]))

        singles = [a for a in rec.aligns if id(a["src"]) in number and id(a["trg"]) in number
                   and a["method"] == reference.PHOTO_DEPTH and a["occlusion"] == 0]
        for full in (False, True):
            group = [a for a in singles if a["full_coverage"] == full]
            n = w["check"]["loop_closure" if full else "tracking"]
            jobs = [(number[id(a["src"])], [number[id(a["trg"])]], [a["guess"]],
                     [None if a["result"]["ill"] else (a["result"]["pose"], a["result"]["av_depth"],
                                                       a["result"]["iters"])])
                    for a in (group[k] for k in pick(len(group), n))]
            compare_aligns(jobs, full)
        batches = [b for b in rec.batches if id(b["src"]) in number and all(id(t) in number for t in b["trgs"])]
        if batches:
            largest = max(range(len(batches)), key=lambda k: len(batches[k]["cands"]))
            others = [k for k in range(len(batches)) if k != largest]
            chosen = [largest] + [others[k] for k in pick(len(others), w["check"]["loop_closure"] - 1)]
            compare_aligns([(number[id(batches[k]["src"])], [number[id(t)] for t in batches[k]["trgs"]],
                             batches[k]["guesses"], [batches[k]["results"].get(c) for c in batches[k]["cands"]])
                            for k in chosen], True)
        if rec.graphs:
            g = max(rec.graphs, key=lambda g: (len(g["vertices"]), len(g["edges"])))
            ref = reference.optimize(g["vertices"], g["edges"], *g["args"], robust=g["robust"])
            prog = g["after"]
            if control:
                with reference.precision(lower=True):
                    prog = reference.optimize(g["vertices"], g["edges"], *g["args"], robust=g["robust"])
            for p, r in zip(prog, ref):
                t_mm, r_deg = pose_gap(p, r)
                worst.add("graph_t_mm", t_mm)
                worst.add("graph_r_deg", r_deg)
        return [(name, value, limits[name]) for name, value in worst.values.items()]
