"""The traced run's device trace and host spans.

``DeviceTrace`` runs torch.profiler over the last ``seconds`` of the
window and reduces it to what the per-layer readers and the breakdown
need: the device's busy time (the union of the CUDA kernel, copy and set
intervals, frozen from tools/profile_slam_loop.py's ``union_us``), device
time by operation, the warp-gather kernel's launches in order, and the
idle gaps labelled by what the host was doing (the innermost host span
open at the gap's start, and the innermost profiled host operation).

``StageLines`` turns the program's stage brackets (rgbd360_torch/utils/
timing.py prints "<stage> took <ms> ms" when a bracket closes) into host
spans; ``gather_launches`` records the shapes of each warp-gather launch
so that a reader can price it with lib/roofline.py.
"""

from __future__ import annotations

import bisect
import contextlib
import io
import re
import time

GATHER_KERNEL = "warp_gather_kernel"
_STAGE_LINE = re.compile(r"(.+) took ([0-9.]+) ms")


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class StageLines(io.TextIOBase):
    """A stdout that keeps each stage bracket as a host span (name, start,
    end) in perf_counter seconds, and drops everything else the program
    prints."""

    def __init__(self):
        self.spans = []

    def write(self, s: str) -> int:
        m = _STAGE_LINE.fullmatch(s.strip())
        if m:
            end = time.perf_counter()
            self.spans.append((m.group(1), end - float(m.group(2)) / 1000.0, end))
        return len(s)


class DeviceTrace:
    """torch.profiler (host and CUDA activity) over the last ``seconds`` of
    the window: the profiler slows host issue, and it leaves the process
    slower after it stops, so the untraced part of the window comes first."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof = None
        self.t0 = self.t1 = None
        self.launches = []  # (kind, bytes) of each warp-gather launch, in order
        self.host_spans = []  # (name, start, end) perf_counter seconds
        self.busy_s = self.window_s = None
        self.kernels = []  # (start_us, duration_us) of the warp-gather launches
        self.by_name = {}
        self.gaps = {}

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with record_function("bench.anchor"):
            self.t0 = time.perf_counter()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def digest(self) -> None:
        """Reduce the trace (the profiler's raw events: FunctionEvent trees
        take minutes at this size)."""
        from torch.autograd import DeviceType

        device, host, anchor = [], [], None
        for e in self.prof.profiler.kineto_results.events():
            a = e.start_ns() / 1000.0
            b = a + e.duration_ns() / 1000.0
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation() and not name.startswith("ProfilerStep"):
                    device.append((a, b, name))
            elif name == "bench.anchor":
                anchor = a
            elif not e.is_user_annotation():
                host.append((a, b, name))
        self.prof = None
        self.window_s = self.t1 - self.t0
        self.busy_s = union_us([(a, b) for a, b, _n in device]) / 1e6
        for a, b, name in device:
            self.by_name[name] = self.by_name.get(name, 0.0) + (b - a) / 1e6
        self.kernels = sorted((a, b - a) for a, b, name in device if GATHER_KERNEL in name)
        if anchor is None or not device:
            return
        offset = anchor - self.t0 * 1e6  # profiler us = perf_counter s * 1e6 + offset
        spans = sorted((s * 1e6 + offset, e * 1e6 + offset, n) for n, s, e in self.host_spans)
        host.sort()
        host_starts = [h[0] for h in host]
        span_starts = [s[0] for s in spans]
        busy = merged([(a, b) for a, b, _n in device])
        edges = [anchor] + [x for iv in busy for x in iv] + [anchor + self.window_s * 1e6]
        for k in range(0, len(edges) - 1, 2):
            g0, g1 = edges[k], edges[k + 1]
            if g1 <= g0:
                continue
            label = f"{_innermost(spans, span_starts, g0) or 'no stage'}: {_innermost(host, host_starts, g0) or 'no op'}"
            self.gaps[label] = self.gaps.get(label, 0.0) + (g1 - g0) / 1e6

    def breakdown(self) -> dict:
        top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.by_name), "idle_gaps": top(self.gaps)}


def _innermost(intervals, starts, t: float, scan: int = 4000):
    """Name of the latest-starting interval that contains ``t``."""
    k = bisect.bisect_right(starts, t)
    for a, b, name in reversed(intervals[max(0, k - scan):k]):
        if b >= t:
            return name
    return None


@contextlib.contextmanager
def gather_launches(trace: DeviceTrace):
    """Record each warp-gather launch's kind and bytes (lib/roofline.py)
    while the profiler runs."""
    from bench360.lib.roofline import gather_bytes
    from rgbd360_torch.ops import warp_gather

    real = (warp_gather.warp_gather_batched, warp_gather.warp_gather_batched_multi)

    def note(kind, planes, r_idx, active):
        if trace.active:
            b, ht, _c, wt = planes.shape
            trace.launches.append((kind, gather_bytes(b, ht, wt, r_idx.shape[1], r_idx.shape[2], active is not None)))

    def batched(planes, r_idx, c_idx, active=None, *a, **k):
        note("windowed", planes, r_idx, active)
        return real[0](planes, r_idx, c_idx, active, *a, **k)

    def multi(planes, r_idx, c_idx, active, *a, **k):
        anchors = k.get("anchors", a[1] if len(a) > 1 else warp_gather.DUAL)
        note("full" if tuple(anchors) == warp_gather.FULL else "dual", planes, r_idx, active)
        return real[1](planes, r_idx, c_idx, active, *a, **k)

    warp_gather.warp_gather_batched, warp_gather.warp_gather_batched_multi = batched, multi
    try:
        yield
    finally:
        warp_gather.warp_gather_batched, warp_gather.warp_gather_batched_multi = real
