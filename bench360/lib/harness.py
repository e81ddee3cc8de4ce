"""The benchmark's harness: one run of one cell.

Everything a cell needs is found by name, so that a later change adds a
configuration, a cell or a metric as new files and entries of
BENCHMARK.json, and edits none:

  BENCHMARK.json                   the cell's entry, its metrics and bounds
  bench360/configs/<config>.json   the deployment (sizes, source, cuts)
  bench360/workloads/<cell>.json   the traffic: its driver and parameters,
                                   and the limits of its correctness check
  bench360/drivers/<driver>.py     the general generator of that traffic
  bench360/metrics/<metric>.py     one per-layer metric's reader

A driver module defines ``Driver(ctx)`` with ``setup()``, ``window()``,
``release()`` and ``check(control=False)``; a metric module defines
``read(ctx)``, which returns a number or None (nothing to read: the metric
is left out of the line).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "rgbd360_tpu")


class Bench:
    """BENCHMARK.json and the files it names."""

    def __init__(self, bench_json: str, bench_dir: str = BENCH_DIR):
        with open(bench_json) as f:
            self.spec = json.load(f)
        self.dir = bench_dir

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def _json(self, sub: str, name: str) -> dict:
        with open(os.path.join(self.dir, sub, f"{name}.json")) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def workload(self, name: str) -> dict:
        return self._json("workloads", name)

    def _module(self, sub: str, name: str):
        path = os.path.join(self.dir, sub, f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"bench360_{sub}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def driver(self, name: str):
        return self._module("drivers", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list:
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


class Context:
    """What a driver and the metric readers share for one run."""

    def __init__(self, args, cell: dict, config: dict, workload: dict, device, tmp: str):
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.cell = cell
        self.config = config
        self.workload = workload
        self.device = device
        self.tmp = tmp
        self.workers = max(1, min(8, os.cpu_count() or 1))
        self.e2e = {}  # end-to-end metric -> value
        self.attempted = 0
        self.failed = 0
        # per-layer sources, filled in the traced run: stage totals (ms) and
        # counters over the untraced rest of the window, the number of units
        # (pairs, frames) they cover, and the device trace
        self.stages = {}
        self.counters = {}
        self.units = 0
        self.device_trace = None
        self.power_limit = None
        self.device_kind = None

    def note(self, text: str) -> None:
        print(text, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True, help="the cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: report the per-layer metrics from a traced run")
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def cache_dirs(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout: later runs of a cell
    there find what the first one built. The program builds its own CUDA
    library and native loader into rgbd360_torch/_build/."""
    cache = os.path.join(root, "bench360", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("RGBD360_PRINT_TIMINGS", None)


def run(argv=None, *, bench_json: str = None, bench_dir: str = BENCH_DIR, device: str = None,
        t_process: float = None, control: bool = False) -> int:
    """One run. ``device`` None looks for the card and refuses to run
    without one; tests pass "cpu" to drive the rest of a run here.
    ``control``: the correctness check's control stands in the program's
    place (bench360/tests/test_bench360_control.py)."""
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse_args(argv)
    root = os.path.dirname(bench_dir)
    bench = Bench(bench_json or os.path.join(os.getcwd(), "BENCHMARK.json"), bench_dir)
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    workload = bench.workload(cell["name"])
    cache_dirs(root)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"no result: the cell needs {cell['chips']} CUDA device(s), "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="bench360_", dir=os.environ.get("TMPDIR"))
    try:
        ctx = Context(args, cell, config, workload, dev, tmp)
        if dev.type == "cuda":
            ctx.device_kind = torch.cuda.get_device_name(0)
            ctx.power_limit = card_power_limit()
            ctx.note(f"card: {ctx.power_limit or 'power limit not read'}; "
                     f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        drv = bench.driver(workload["driver"]).Driver(ctx)
        drv.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        # what set-up made stays: the window's garbage collections scan only
        # what the window allocates
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_process
        drv.window()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                    "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                    "count": cell["chips"],
                    "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0}
        found = forbidden_modules()
        if found:
            print(f"no result: the run loaded {', '.join(found)}", file=sys.stderr)
            return 3
        metrics, breakdown = {}, None
        ctx.note(f"setup_s {setup_s!r}; " + "; ".join(f"{k} {v!r}" for k, v in ctx.e2e.items())
                 + f"; memory_peak_bytes {dev_info['memory_peak_bytes']}")
        if ctx.trace:
            for m in bench.per_layer(cell["name"]):
                value = bench.metric(m["name"]).read(ctx)
                if value is None:
                    # left out of the line, which the check refuses for a
                    # metric BENCHMARK.json lists for this cell
                    ctx.note(f"per-layer metric {m['name']}: nothing to read in this run")
                else:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if ctx.device_trace is not None:
                dev_info["busy_s"] = ctx.device_trace.busy_s
                dev_info["window_s"] = ctx.device_trace.window_s
                breakdown = ctx.device_trace.breakdown()
        else:
            ctx.e2e["setup_s"] = setup_s
            for m in bench.end_to_end(cell["name"]):
                metrics[m["name"]] = {"value": ctx.e2e[m["name"]], "unit": m["unit"]}
        drv.release()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = drv.check(control=control)
        ctx.note(f"check: {time.perf_counter() - t_check:.1f} s")
        found = forbidden_modules()
        if found:
            print(f"no result: the run loaded {', '.join(found)}", file=sys.stderr)
            return 3
        correct = bool(checks) and ctx.attempted > 0 and all(
            math.isfinite(v) and v <= limit for _n, v, limit in checks)
        for name, value, limit in checks:
            print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
        print(f"correct {correct}", file=sys.stderr, flush=True)
        line = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed,
                "metrics": metrics, "device": dev_info}
        if breakdown is not None:
            line["breakdown"] = breakdown
        line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
        print(json.dumps(line), flush=True)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
