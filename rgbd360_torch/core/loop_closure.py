"""LoopClosure360 — loop-closure search (reference include/LoopClosure360.h).

Counterpart of rgbd360_tpu/core/loop_closure.py. For each new keyframe:
scan candidates (same-area KFs at least 6 m of trajectory apart within a
distance threshold, plus the selected KFs of other areas within 5 m),
screen them with the batched plane-compatibility prefilter on the device
(core/batch_match.py), register PbMaps on the host (PLANAR_3DoF, accept at
>5 matches and matched area > 15), refine on the device with the dense
spherical aligner seeded through the 157.5 deg rotOffset conjugation, and
accept when avDepthResidual < 2.0 — then add the graph edge, the map
connection and the SSO handoff entry (reference :108-378).

The dense refinement runs with full coverage: every windowed sweep takes
the triple-anchored (mean, min, max) gather, on the card the FULL form of
csrc/warp_gather.cu. Two or more survivors go through ONE
``align_batch(..., full_coverage=True)`` (``_refine_batch``), a single one
through the facade's ``align_frames360(..., full_coverage=True)``. On a
CUDA device with more than one card visible, ``_refine_batch`` splits the
survivors into min(b, cards) contiguous shards, one ``align_batch`` per
card (parallel/mesh.py::align_shards; JAX splits its bucket over the pair
mesh, loop_closure.py:232-258); the result is bit-equal to the unsplit
call.

Differences from the JAX module, each for a reason:
  * no power-of-two bucket padding of the batch: it lets XLA reuse one
    compiled executable, and the port compiles nothing (each pair of a
    batch is computed independently: tests/test_torch_loop_closure.py
    holds the poses equal with and without padding);
  * the split has shards of unequal size where b does not divide (JAX
    splits its power-of-two bucket over the largest power-of-two device
    count that divides it);
  * ``device``: the aligner and the prefilter run on it, the card unless
    the caller names another.

The search is exposed synchronously (``process_new_keyframe``,
deterministic) and on a daemon thread (``start``/``notify_keyframe``/
``stop``) mirroring the reference's threading (ctor at :83-94). The thread
is one per device for the process (``worker_of``), which every loop closer
hands its keyframes to in turn. On a card it issues all of its device work
on a stream of its own, which first waits on an event that
``notify_keyframe`` records on the caller's stream: the thread reads a
keyframe's panorama only once the tracking stream has written it, and its
results reach the host through its stream alone. Its CUDA graphs are its
thread's own (ops/level_graphs.py), captured under the process's capture
lock and replayed on its stream. ``wait`` returns once every keyframe
notified before it has been searched; ``stop`` waits so, then lets the
thread go.

Traced (utils/timing.py): the span "LC dense refinement" (attr ``pairs``)
covers phase 2, batched or single, up to its read-back, and the span "loop
closure (thread)" (attr ``frame``) each keyframe the thread takes; the
counter groups ``LC`` (the search's funnel) and ``THREAD`` (the thread's
queue) count over every loop closer of the process.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rgbd360_torch.apps.common import rot_offset
from rgbd360_torch.core.batch_match import prefilter_candidates
from rgbd360_torch.core.map360 import Map360
from rgbd360_torch.core.matcher import PLANAR_3DOF
from rgbd360_torch.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP
from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360
from rgbd360_torch.device import resolve_device
from rgbd360_torch.parallel import mesh as pmesh
from rgbd360_torch.parallel.batch import align_batch
from rgbd360_torch.utils import timing

MIN_MATCHES = 5  # reference :297
MIN_AREA_MATCHED = 15.0  # reference :298
MAX_DEPTH_RESIDUAL = 2.0  # reference :316
MIN_TRAJECTORY_GAP = 6.0  # metres of trajectory between candidates (:173-179)
MAX_CANDIDATE_DIST = 5.0  # metres (:291-294)

# The search's funnel, summed over process_new_keyframe calls: "keyframes"
# searched, "candidates" the scan found, "prefilter_kept" those the plane
# prefilter passed on to PbMap registration (all of them where it does not
# run), "pbmap_kept" the survivors of registration, "refinements" the dense
# refinements run (batched or single), "refined_pairs" their pairs,
# "accepted" the closures accepted.
LC = timing.counter_group("loop_closure.LC", {"keyframes": 0, "candidates": 0, "prefilter_kept": 0,
                                              "pbmap_kept": 0, "refinements": 0, "refined_pairs": 0,
                                              "accepted": 0})
# The background thread's queue, summed over the process's loop closers:
# "notified" keyframes queued, "taken" those the thread took, "queued_at_take"
# the sum over takes of the keyframes still waiting behind the one taken,
# "busy_ns" the thread's time on its keyframes, "drain_ns" the caller's stop
# and final drain (apps/sphere_graph_slam.py), "dropped" keyframes notified
# but not taken when stop() returns (0: stop waits for the queue).
THREAD = timing.counter_group("loop_closure.THREAD", {"notified": 0, "taken": 0, "queued_at_take": 0,
                                                      "busy_ns": 0, "drain_ns": 0, "dropped": 0})


class _Worker:
    """The loop closers' thread on one device: long-lived and, on a card,
    with a stream of its own, it runs the jobs that every loop closer of
    the process queues, in turn. Its CUDA graphs are its thread's own
    (ops/level_graphs.py), so they live as long as the process, as the
    tracking thread's do: a thread made per session would capture them anew
    in every session, and its stream, drawn anew, would cycle through
    torch's pool of streams and come to share one with another thread's
    captures."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.jobs: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._run, daemon=True, name="LoopClosure360").start()

    def _run(self) -> None:
        with torch.cuda.stream(self.stream) if self.stream is not None else nullcontext():
            while True:
                self.jobs.get()()


_WORKERS: Dict[torch.device, _Worker] = {}
_WORKERS_LOCK = threading.Lock()


def worker_of(device: torch.device) -> _Worker:
    """The loop closers' thread (and stream) on ``device``, made at its
    first use."""
    with _WORKERS_LOCK:
        if device not in _WORKERS:
            _WORKERS[device] = _Worker(device)
        return _WORKERS[device]


class LoopClosure360:
    def __init__(
        self,
        map360: Map360,
        optimizer=None,
        config_file: Optional[str] = None,
        n_pyr_levels: int = 5,
        device=None,
    ):
        self.map = map360
        self.optimizer = optimizer
        self.device = resolve_device(device)
        self.registerer = RegisterRGBD360(config_file)
        self.aligner = RegisterPhotoICP(n_pyr_levels, device=self.device)
        self.rot_offset = rot_offset()
        # kf -> {other: sso} handoff to the SLAM loop (reference connectionsLC)
        self.connections_lc: Dict[int, Dict[int, float]] = {}
        # the pairs of each dense refinement run (1: the facade's)
        self.refinements: List[int] = []
        # (candidate, keyframe, refined in a batch) of each accepted closure
        self.accepted: List[Tuple[int, int, bool]] = []
        # the thread's worker from start() to stop()
        self._worker: Optional[_Worker] = None
        self._error: Optional[BaseException] = None
        self._notified = self._taken = 0

    # -- candidate scan (reference :173-294) -------------------------------------
    def _candidates(self, kf_id: int):
        """Callers must hold map.mutex: the threaded mode scans areas /
        selected_kfs that the SLAM loop's partitioner mutates."""
        m = self.map
        new_pose = m.trajectory_poses[kf_id]
        area = m.frames[kf_id].node
        cands = []
        for other in sorted(m.areas[area], reverse=True):
            if other == kf_id:
                continue
            gap = m.trajectory_increments[kf_id] - m.trajectory_increments[other]
            if gap < MIN_TRAJECTORY_GAP:
                continue
            dist = float(np.linalg.norm(new_pose[:3, 3] - m.trajectory_poses[other][:3, 3]))
            if dist < MAX_CANDIDATE_DIST:
                cands.append(other)
        for other_area, selected in enumerate(m.selected_kfs):
            if other_area == area or other_area >= len(m.areas) or not m.areas[other_area]:
                continue
            if selected >= kf_id:
                # threaded mode: a closure against a NEWER keyframe belongs to
                # that keyframe's own scan (and Map360.add_connection requires
                # kf1 < kf2)
                continue
            dist = float(np.linalg.norm(new_pose[:3, 3] - m.trajectory_poses[selected][:3, 3]))
            if dist < MAX_CANDIDATE_DIST:
                cands.append(selected)
        return cands

    # -- one keyframe (reference run() body, :108-378) ----------------------------
    def process_new_keyframe(self, kf_id: int) -> int:
        """Search loop closures for kf_id. Returns the number accepted."""
        m = self.map
        new_kf = m.frames[kf_id]
        accepted = 0
        with m.mutex:
            cands = self._candidates(kf_id)
        timing.count(LC, "keyframes")
        timing.count(LC, "candidates", len(cands))
        if len(cands) > 1 and new_kf.planes is not None and all(m.frames[c].planes is not None for c in cands):
            counts, areas = prefilter_candidates(
                new_kf.planes, [m.frames[c].planes for c in cands],
                self.registerer.matcher.config, PLANAR_3DOF, device=self.device,
            )
            cands = [c for k, c in enumerate(cands) if counts[k] >= MIN_MATCHES and areas[k] > MIN_AREA_MATCHED]
        timing.count(LC, "prefilter_kept", len(cands))
        # phase 1 (host): exact PbMap registration per candidate; survivors
        # carry their seed pose into the dense phase
        survivors = []  # (cand_id, seed pose in sphere frame)
        for cand in cands:
            cand_kf = m.frames[cand]
            ok = self.registerer.register_pbmap(cand_kf, new_kf, 25, PLANAR_3DOF)
            # reference gates STRICTLY greater than the thresholds (:297-298)
            if (
                not ok
                or len(self.registerer.get_matched_planes()) <= MIN_MATCHES
                or self.registerer.get_area_matched() <= MIN_AREA_MATCHED
            ):
                continue
            rel = self.registerer.get_pose()
            # TARGET = candidate (older), SOURCE = new keyframe: the optimal
            # pose is X_cand^-1 X_new, the optimizer's edge convention
            guess = self.rot_offset @ rel @ np.linalg.inv(self.rot_offset)
            survivors.append((cand, guess))

        timing.count(LC, "pbmap_kept", len(survivors))

        # phase 2 (device): dense refinement, full coverage — ONE batched
        # align for >= 2 survivors, the facade for a single one
        results = []  # (cand_id, pose_sphere, av_depth, H, sso)
        if survivors:
            self.refinements.append(len(survivors))
            timing.count(LC, "refinements")
            timing.count(LC, "refined_pairs", len(survivors))
            with timing.span("LC dense refinement", pairs=len(survivors)):
                if len(survivors) >= 2:
                    results = self._refine_batch(new_kf, survivors)
                else:
                    cand, guess = survivors[0]
                    cand_kf = m.frames[cand]
                    self.aligner.set_target_frame(cand_kf.sphere_rgb, cand_kf.sphere_depth_mm)
                    self.aligner.set_source_frame(new_kf.sphere_rgb, new_kf.sphere_depth_mm)
                    self.aligner.align_frames360(guess, PHOTO_DEPTH, full_coverage=True)
                    # the ill-posed filter of _refine_batch: a singular system
                    # leaves the pose at the PbMap seed with a degenerate Hessian
                    if not self.aligner.ill_posed:
                        results = [(
                            cand, self.aligner.get_optimal_pose(), float(self.aligner.av_depth_residual),
                            self.aligner.get_hessian(), float(self.aligner.sso),
                        )]

        # phase 3 (host): acceptance + graph wiring (:316-323)
        for cand, pose_sphere, av_depth, info, sso in results:
            if av_depth >= MAX_DEPTH_RESIDUAL:
                continue
            rel = np.linalg.inv(self.rot_offset) @ pose_sphere.astype(np.float64) @ self.rot_offset
            with m.mutex:  # the SLAM loop drains connections_lc under it
                if self.optimizer is not None:
                    self.optimizer.add_edge(cand, kf_id, rel, info)
                m.add_connection(cand, kf_id, rel, info)
                self.connections_lc.setdefault(kf_id, {})[cand] = sso
                self.accepted.append((cand, kf_id, len(survivors) >= 2))
            accepted += 1
        timing.count(LC, "accepted", accepted)
        return accepted

    def _refine_batch(self, new_kf, survivors):
        """One align_batch call over all surviving candidates, with full
        coverage: the new keyframe's panorama is the source of every pair,
        each candidate's the target. With more than one card beside the
        loop closer's (pmesh.pair_devices), the pairs split into min(b,
        cards) contiguous shards, one card each. Returns (cand, pose,
        av_depth, H, sso) per pair that is not ill-posed."""
        m = self.map
        b = len(survivors)
        dev = self.device
        metres = lambda depth_mm: depth_mm.to(dev).to(torch.float32) * 0.001
        src_gray = new_kf.sphere_gray.to(dev)
        gs = src_gray[None].expand(b, -1, -1).contiguous()
        ds = metres(new_kf.sphere_depth_mm)[None].expand(b, -1, -1).contiguous()
        gt = torch.stack([m.frames[c].sphere_gray.to(dev) for c, _g in survivors])
        dt = torch.stack([metres(m.frames[c].sphere_depth_mm) for c, _g in survivors])
        seeds = torch.from_numpy(np.stack([g.astype(np.float32) for _c, g in survivors])).to(dev)
        kwargs = dict(method=PHOTO_DEPTH, n_levels=self.aligner.n_pyr_levels, full_coverage=True)
        mesh = pmesh.pair_devices(dev)
        if len(mesh) > 1:
            mesh = mesh[:min(b, len(mesh))]
            res = pmesh.align_shards(mesh, *pmesh.split_pairs(mesh, gs, ds, gt, dt, seeds), **kwargs)
        else:
            res = align_batch(gs, ds, gt, dt, seeds, **kwargs)
        # one read-back of what the acceptance reads
        flat = torch.cat(
            [res.pose.reshape(b, -1), res.hessian.reshape(b, -1), res.av_depth_residual[:, None],
             res.sso[:, None], res.ill_posed[:, None].to(torch.float32)], dim=1,
        ).cpu().numpy()
        out = []
        for k, (cand, _guess) in enumerate(survivors):
            if flat[k, 54] != 0.0:  # ill-posed
                continue
            out.append((cand, flat[k, :16].reshape(4, 4).copy(), float(flat[k, 52]),
                        flat[k, 16:52].reshape(6, 6).copy(), float(flat[k, 53])))
        return out

    # -- background thread (reference ctor :83-94) ---------------------------------
    def notify_keyframe(self, kf_id: int, frame: Optional[int] = None) -> None:
        """Queue kf_id for the thread; ``frame`` names the caller's frame in
        the thread's span. On a card, an event recorded on the caller's
        stream marks what the thread must wait for before it reads."""
        if self._worker is None:
            raise RuntimeError("LoopClosure360.notify_keyframe before start()")
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._notified += 1
        timing.count(THREAD, "notified")
        self._worker.jobs.put(functools.partial(self._take, (kf_id, kf_id if frame is None else frame, event)))

    def start(self) -> None:
        """Hand this loop closer's keyframes to the device's loop-closure
        thread (worker_of)."""
        if self._worker is None:
            self._worker = worker_of(self.device)

    def _take(self, item: tuple) -> None:
        """Search one notified keyframe, on the thread and its stream."""
        kf_id, frame, event = item
        self._taken += 1
        timing.count(THREAD, "taken")
        timing.count(THREAD, "queued_at_take", self._notified - self._taken)
        t0 = time.perf_counter_ns()
        try:
            if event is not None:
                torch.cuda.current_stream(self.device).wait_event(event)
            with timing.span("loop closure (thread)", frame=frame):
                self.process_new_keyframe(kf_id)
        except Exception as exc:  # keep the thread alive, as the reference's; stop() raises it
            print(f"LoopClosure360: error on kf {kf_id}: {exc!r}")
            if self._error is None:
                self._error = exc
        timing.count(THREAD, "busy_ns", time.perf_counter_ns() - t0)

    def wait(self) -> None:
        """Return once every keyframe notified before this call has been
        searched (and its closures handed over)."""
        if self._worker is not None:
            done = threading.Event()
            self._worker.jobs.put(done.set)
            done.wait()

    def stop(self) -> None:
        """Search every keyframe notified before this call, then let the
        thread go; raise the first exception the thread caught, if any. A
        keyframe notified and still not taken then counts as dropped."""
        if self._worker is not None:
            self.wait()
            if self._worker.stream is not None:
                self._worker.stream.synchronize()
            self._worker = None
        timing.count(THREAD, "dropped", self._notified - self._taken)
        self._notified = self._taken = 0
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc
