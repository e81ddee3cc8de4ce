"""Per-stage wall-clock brackets mirroring the reference's stdout timing
oracle (pcl::getTime() prints around every stage: Frame360.h:295-308
load/undistort, :403-404 stitch, :433-434 cloud, :626-627 segmentation;
RegisterPhotoICP.h:4522,4776 dense alignment; RegisterRGBD360.h:298-299
compareSubgraphs). Stage boundaries keep the reference's names so numbers
compare directly.

Enable with RGBD360_PRINT_TIMINGS=1 (or stage_timing(True)); disabled,
brackets are a no-op (no printing, no accumulation). On a CUDA device a
stage's work may complete after the bracket exits (launches are async) —
brackets measure the host-blocking portion exactly like the reference's
brackets measure its synchronous calls; pass `sync=torch.cuda.synchronize`
to force completion inside the bracket when measuring device stages (it
runs only when timing is on). A copy of rgbd360_tpu/utils/timing.py.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_enabled = os.environ.get("RGBD360_PRINT_TIMINGS") == "1"
_totals = defaultdict(float)
_counts = defaultdict(int)
# planes_pipeline's threaded collector runs its brackets on a worker thread
_acc_lock = threading.Lock()


def stage_timing(on: bool) -> None:
    global _enabled
    _enabled = on


def timing_enabled() -> bool:
    return _enabled


@contextmanager
def stage(name: str, sync=None):
    """Bracket one pipeline stage; when enabled, prints '<name> took <ms> ms'
    like the reference and accumulates into the summary (no-op otherwise)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            sync()
        dt = (time.perf_counter() - t0) * 1000.0
        with _acc_lock:
            _totals[name] += dt
            _counts[name] += 1
        print(f"{name} took {dt:.2f} ms")


def timing_summary() -> dict:
    """{stage: (total_ms, count, mean_ms)} accumulated since reset."""
    return {
        k: (_totals[k], _counts[k], _totals[k] / max(_counts[k], 1)) for k in _totals
    }


def reset_timing() -> None:
    _totals.clear()
    _counts.clear()
