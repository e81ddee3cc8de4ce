"""Sessions of the program's SphereGraphSLAM app with its loop closer on a
thread of its own (``run(..., "--lc-thread")``, the reference app's
deployment), back to back: drivers/slam.py's traffic, window, timing and
check, imported, with what the thread changes.

Traffic parameters (bench360/workloads/<cell>.json): drivers/slam.py's,
with the limits of lc_searched, lc_dropped and lc_undrained. The counts
``expect`` holds are exact, as in the synchronous cell: tracking reads
nothing the loop closer makes, and the app waits for the thread before
each partition, so the thread searches each keyframe in the map the
synchronous mode searches it in.

A session's last frame ends when run() returns: the loop closer's stop,
which searches every keyframe still queued, and the app's final drain are
timed inside the window and charged to that frame. Set-up runs one whole
session after drivers/slam.py's warm-up: the loop closer's thread lives as
long as the process, and its CUDA graphs of the batch sizes a session
meets are captured there, not in the window.

The check is drivers/slam.py's (the panoramas, a sample of the tracking
and loop-closure aligns, the largest graph, each whole session's counts
and ATE), and over each whole session: ``lc_searched``, the keyframes the
thread took less (keyframes - 1); ``lc_dropped``, those it never took;
``lc_undrained``, the closures it accepted that are no edge of the
session's last graph optimization. A program without the thread's counter
group (``loop_closure.THREAD``) fails at once in setup().

The thread's counts for the per-layer readers (``ctx.counters``: ``lc_<key>``
of ``loop_closure.THREAD`` and ``lc_sessions``) sum the whole sessions of the
window that ended before the trace started (the whole window when
untraced), the part of the window ``ctx.stages`` covers; a session cut by
the deadline or the trace's start is left out.

The traced run starts its profiler under the program's capture lock
(ops/level_graphs.py): the profiler's start syncs the whole device, which
CUDA refuses while the loop closer's thread captures a graph.
"""

from __future__ import annotations

import contextlib
import time

from bench360.drivers import slam
from bench360.lib.compare import Worst
from bench360.lib.trace import DeviceTrace

SESSION_CHECKS = ("lc_searched", "lc_dropped", "lc_undrained")


def thread_counts() -> dict:
    from rgbd360_torch.core import loop_closure

    return dict(loop_closure.THREAD)


class _Trace(DeviceTrace):
    def __init__(self, seconds: float, on_start):
        super().__init__(seconds)
        self.on_start = on_start

    def start(self) -> None:
        from rgbd360_torch.ops import level_graphs

        self.on_start()
        lock = getattr(level_graphs, "_CAPTURE_LOCK", None)
        with lock if lock is not None else contextlib.nullcontext():
            super().start()


class Driver(slam.Driver):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.traced = False  # the window's trace has started
        self.untraced = {}  # THREAD counts of the whole sessions before it
        self.sessions = 0  # and their number

    def _check_config(self) -> None:
        from rgbd360_torch.core import loop_closure

        super()._check_config()
        if not self.ctx.config.get("lc_thread"):
            raise RuntimeError("the configuration does not run the loop closer on its thread")
        if not hasattr(loop_closure, "THREAD"):
            raise RuntimeError("the program's loop closer counts no thread (loop_closure.THREAD): "
                               "it cannot run this configuration")

    def setup(self) -> None:
        super().setup()
        t0 = time.perf_counter()
        self._session(self.seq)
        self.ctx.note(f"set-up: a whole warm-up session in {time.perf_counter() - t0:.3f} s")

    def _session(self, dataset: str, sink=None, on_frame=None):
        from rgbd360_torch.apps import sphere_graph_slam

        real = sphere_graph_slam.run
        before, graphs = thread_counts(), len(self.rec.graphs)
        sphere_graph_slam.run = lambda argv: real(list(argv) + ["--lc-thread"])
        try:
            session, times = super()._session(dataset, sink, on_frame)
        finally:
            sphere_graph_slam.run = real
        if times:
            times[-1] = time.perf_counter()  # the stop and the final drain end the last frame
        after = thread_counts()
        session.bench_thread = {k: after[k] - before[k] for k in after}
        session.bench_last_graph = ({(e[0], e[1]) for e in self.rec.graphs[-1]["edges"]}
                                    if len(self.rec.graphs) > graphs else set())
        if self.rec.on and not self.traced and len(times) == self.w["use_frames"]:
            for k, v in session.bench_thread.items():
                self.untraced[k] = self.untraced.get(k, 0) + v
            self.sessions += 1
        return session, times

    def window(self) -> None:
        real = slam.DeviceTrace
        slam.DeviceTrace = lambda seconds: _Trace(seconds, lambda: setattr(self, "traced", True))
        try:
            super().window()
        finally:
            slam.DeviceTrace = real
        self.ctx.counters = {f"lc_{k}": v for k, v in self.untraced.items()}
        self.ctx.counters["lc_sessions"] = self.sessions

    def summary(self, session) -> dict:
        out = super().summary(session)
        counts, accepted = session.bench_thread, session.loop_closer.accepted
        out.update(lc_searched=counts["taken"], lc_dropped=counts["dropped"],
                   lc_undrained=sum(1 for c, k, _b in accepted if (c, k) not in session.bench_last_graph))
        return out

    def check(self, control: bool = False) -> list:
        checks = super().check(control)
        if not checks:
            return checks
        mine = Worst(*(n for n in SESSION_CHECKS if n in self.w["limits"]))
        for s in self.rec.sessions:
            mine.add("lc_searched", abs(s["lc_searched"] - (s["keyframes"] - 1)))
            mine.add("lc_dropped", s["lc_dropped"])
            mine.add("lc_undrained", s["lc_undrained"])
        found = mine.values
        return [(name, found.get(name, value), limit) for name, value, limit in checks]
