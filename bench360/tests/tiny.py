"""A copy of the benchmark with two tiny cells added as files only, for
the CPU tests: a new workload file per cell and its entries in a copy of
BENCHMARK.json, no file of the benchmark edited."""

import contextlib
import io
import json
import os
import shutil
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench360.lib import harness  # noqa: E402

# (the cell it copies, the parameters it changes, the limits it drops: a
# tiny SLAM session closes no loop and optimizes no graph)
TINY = {
    "pair360.tiny": ("pair360.track-b8", {"circle": {"frames": 3, "deg_per_step": 6.0, "radius": 0.8},
                                          "batch": 2, "warmup_batches": 1, "check_batches": 2}, ()),
    "slam360.tiny": ("slam360.arc20", {"use_frames": 3, "warmup_frames": 2,
                                       "check": {"frames": 2, "tracking": 2, "loop_closure": 1},
                                       "expect": {"keyframes": 3, "planes": 40, "loop_closures": 0, "lc_batched": 0}},
                     ("graph_t_mm", "graph_r_deg")),
}


def make_bench(tmp: str) -> tuple:
    """(BENCHMARK.json, bench dir) of a copy with the tiny cells added."""
    bench_dir = os.path.join(tmp, "bench360")
    shutil.copytree(os.path.join(ROOT, "bench360"), bench_dir,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for name, (like, params, drop) in TINY.items():
        config, traffic = name.split(".")
        w = json.load(open(os.path.join(bench_dir, "workloads", like + ".json")))
        w.update(params, trace_seconds=1)
        w["limits"] = {k: v for k, v in w["limits"].items() if k not in drop}
        with open(os.path.join(bench_dir, "workloads", name + ".json"), "w") as f:
            json.dump(w, f)
        spec["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                                  "why": "a CPU test of the harness"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    bench_json = os.path.join(tmp, "BENCHMARK.json")
    with open(bench_json, "w") as f:
        json.dump(spec, f)
    return bench_json, bench_dir


def run_cell(tmp: str, cell: str, seed: int = 2_200_000_001, seconds: float = 1, trace: int = 0) -> tuple:
    """(exit code, last stdout line as a dict or None) of one run on the CPU."""
    bench_json, bench_dir = make_bench(tmp)
    torch.set_num_threads(2)  # the tests run in parallel workers
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                         bench_json=bench_json, bench_dir=bench_dir, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)
