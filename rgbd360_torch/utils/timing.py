"""The port's tracer: spans kept in memory, counter groups, and the stage
brackets that mirror the reference's stdout timing oracle.

Stages. ``stage(name, sync=None)`` brackets one pipeline stage under the
reference's names, so numbers compare directly (pcl::getTime() prints
around every stage: Frame360.h:295-308 load/undistort, :403-404 stitch,
:433-434 cloud, :626-627 segmentation; RegisterPhotoICP.h:4522,4776 dense
alignment; RegisterRGBD360.h:298-299 compareSubgraphs). Under
``stage_timing(True)`` (or RGBD360_PRINT_TIMINGS=1) a stage runs ``sync``
at its end and prints "<name> took <ms> ms" like the reference. On a CUDA
device a stage's work may complete after the bracket exits (launches are
async): without ``sync`` a bracket measures the host-blocking portion, as
the reference's brackets measure its synchronous calls.

Spans. A stage is a span; ``span(name, **attrs)`` is one without the
printing and the sync. A span records its name, start and end on
``time.perf_counter_ns()`` (the clock bench360's DeviceTrace anchors to the
profiler), the span it opened in (a stack per thread), its thread and its
attrs. A ``frame`` attr is inherited from the enclosing span, so the spans
of one frame share it; a span on another thread names it itself. Spans go
to a buffer of SPAN_CAPACITY (the oldest are dropped) and add to
``timing_summary()``'s totals. While a torch.profiler records, each span
also opens a ``record_function`` range, so it sits on the profiler's
clock beside the kernels.

Spans are recorded while tracing is on: under stage_timing(True), with
RGBD360_TRACE=<path> set (which also writes the spans and counters as a
Chrome trace JSON to <path> at exit; it opens in Perfetto), or while a
torch.profiler records. Off, ``span`` and ``stage`` return a shared no-op
after one flag check.

Counters. Modules register their counter groups (dicts of counts) here;
``count`` adds under COUNT_LOCK (parallel/mesh.py aligns each shard on a
thread of its own) and ``counters()`` snapshots every group. Counters are
always on. ``host_sync`` runs each call that blocks the host on the
device; inside ``sync_scope`` it is counted and timed there.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

SPAN_CAPACITY = 65536

_enabled = os.environ.get("RGBD360_PRINT_TIMINGS") == "1"
_trace_path = os.environ.get("RGBD360_TRACE") or None
_totals = defaultdict(float)
_counts = defaultdict(int)
# planes_pipeline's threaded collector runs its brackets on a worker thread
_acc_lock = threading.Lock()
_spans = deque(maxlen=SPAN_CAPACITY)
_ids = itertools.count(1)
_local = threading.local()  # .stack: the open spans; .scope: the sync scope


class Span(NamedTuple):
    """One finished span; times in perf_counter nanoseconds."""

    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    thread: str
    attrs: dict


def stage_timing(on: bool) -> None:
    global _enabled
    _enabled = on


def timing_enabled() -> bool:
    return _enabled


def tracing() -> bool:
    """Whether spans are recorded now."""
    return _enabled or _trace_path is not None or _profiler._is_profiler_enabled


class _Off:
    """The span of tracing off: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "range", "sync", "printed")

    def __init__(self, name, attrs, sync=None, printed=False):
        self.name, self.attrs, self.sync, self.printed = name, attrs, sync, printed
        self.range = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if parent is not None and "frame" in parent.attrs and "frame" not in self.attrs:
            self.attrs["frame"] = parent.attrs["frame"]
        self.id = next(_ids)
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.printed and self.sync is not None:
            self.sync()
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        stack = _local.stack
        if stack[-1] is self:
            stack.pop()
        else:  # closed out of order (a generator suspended inside its span)
            stack.remove(self)
        _spans.append(Span(self.id, self.parent, self.name, self.t0, t1,
                           threading.current_thread().name, self.attrs))
        dt = (t1 - self.t0) / 1e6
        with _acc_lock:
            _totals[self.name] += dt
            _counts[self.name] += 1
        if self.printed:
            print(f"{self.name} took {dt:.2f} ms")
        return False


def span(name: str, **attrs):
    """A span around a with-block (no-op while tracing is off)."""
    if not tracing():
        return _OFF
    return _Span(name, attrs)


def stage(name: str, sync=None, **attrs):
    """Bracket one pipeline stage: a span that, under stage_timing(True),
    runs ``sync`` at its end and prints '<name> took <ms> ms' like the
    reference (no-op while tracing is off)."""
    if not tracing():
        return _OFF
    return _Span(name, attrs, sync, _enabled)


def spans() -> list:
    """(name, start, end) of the buffered spans in perf_counter seconds, in
    the order they ended: the form of bench360's DeviceTrace.host_spans."""
    return [(s.name, s.start_ns / 1e9, s.end_ns / 1e9) for s in list(_spans)]


def span_records() -> list:
    """The buffered spans (Span), in the order they ended."""
    return list(_spans)


def timing_summary() -> dict:
    """{stage: (total_ms, count, mean_ms)} accumulated since reset."""
    return {
        k: (_totals[k], _counts[k], _totals[k] / max(_counts[k], 1)) for k in _totals
    }


def reset_timing() -> None:
    """Clear the totals and the span buffer."""
    _totals.clear()
    _counts.clear()
    _spans.clear()


# -- counters ---------------------------------------------------------------

# guards every increment of a registered group
COUNT_LOCK = threading.Lock()
_groups = {}


def counter_group(name: str, counts: dict) -> dict:
    """Register ``counts`` under ``name`` and return it (the same dict)."""
    _groups[name] = counts
    return counts


def count(counts: dict, key: str, n: int = 1) -> None:
    """Add ``n`` to ``counts[key]`` under COUNT_LOCK."""
    with COUNT_LOCK:
        counts[key] += n


def reset_counts(counts: dict) -> None:
    with COUNT_LOCK:
        for k in counts:
            counts[k] = 0


def counters() -> dict:
    """{group: {key: value}}, a snapshot of every registered group."""
    with COUNT_LOCK:
        return {name: dict(c) for name, c in _groups.items()}


@contextmanager
def sync_scope(counts: dict, name: str):
    """Count and time on this thread, in ``counts`` ("syncs", "wait_ns"),
    every host_sync the with-block makes; each is a span ``name``."""
    outer = getattr(_local, "scope", None)
    _local.scope = (counts, name)
    try:
        yield
    finally:
        _local.scope = outer


def host_sync(op, *args, **kwargs):
    """``op(*args, **kwargs)``, a call that blocks the host until the device
    has run what was issued before it: a read of a device value (``bool``,
    ``.item()``, ``.cpu()``) or a copy from pageable host memory to the
    device (``to_device``). Counted and timed inside a sync_scope."""
    scope = getattr(_local, "scope", None)
    if scope is None:
        return op(*args, **kwargs)
    counts, name = scope
    with span(name):
        t0 = time.perf_counter_ns()
        out = op(*args, **kwargs)
        waited = time.perf_counter_ns() - t0
    with COUNT_LOCK:
        counts["syncs"] += 1
        counts["wait_ns"] += waited
    return out


def to_device(data, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(data, dtype=dtype, device=device)``. On a CUDA device
    that is a copy from pageable memory, which waits for the stream: a
    host_sync."""
    if device.type == "cpu":
        return torch.tensor(data, dtype=dtype)
    return host_sync(torch.tensor, data, dtype=dtype, device=device)


# -- the Chrome trace ---------------------------------------------------------

def chrome_trace() -> dict:
    """The buffered spans as complete events ("X", microseconds on
    perf_counter) and each counter group's values as one counter event
    ("C") at the latest span's end: the Chrome trace format, which
    Perfetto and chrome://tracing open."""
    records = list(_spans)
    threads = {}
    events = []
    for s in records:
        tid = threads.setdefault(s.thread, len(threads) + 1)
        args = dict(s.attrs, id=s.id)
        if s.parent is not None:
            args["parent"] = s.parent
        events.append({"name": s.name, "ph": "X", "ts": s.start_ns / 1000.0,
                       "dur": (s.end_ns - s.start_ns) / 1000.0, "pid": 1, "tid": tid, "args": args})
    events += [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid, "args": {"name": name}}
               for name, tid in threads.items()]
    t_end = max((s.end_ns for s in records), default=time.perf_counter_ns()) / 1000.0
    events += [{"name": name, "ph": "C", "ts": t_end, "pid": 1, "tid": 0, "args": values}
               for name, values in counters().items()]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(path: str) -> None:
    """Write chrome_trace() to ``path`` as JSON."""
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)


if _trace_path is not None:
    atexit.register(write_trace, _trace_path)
