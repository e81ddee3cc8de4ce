"""The harness on the CPU, at tiny sizes: a cell added as files only runs;
the result line's keys; no card, no result; no JAX module in a run's
process; a reader or a comparison with nothing to read gives no pass; and
every fault a cell can have at this size, planted under the timed path,
turns ``correct`` false (bench360/tests/tiny.py holds the tiny cells; the
faults that need a whole loop are planted on the card,
test_bench360_control.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tiny  # noqa: E402

ROOT = tiny.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
# a window that holds a whole tiny SLAM session (three frames, ~7 s here)
SECONDS = {"pair360": 2, "slam360": 9}


def seconds(cell: str) -> float:
    return SECONDS[cell.split(".")[0]]


@pytest.mark.parametrize("cell", sorted(tiny.TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_added_as_files_runs(tmp_path, cell, trace):
    rc, line = tiny.run_cell(str(tmp_path), cell, seconds=seconds(cell) + 8 * trace, trace=trace)
    assert rc == 0 and line["correct"] is True and line["attempted"] > 0
    assert list(line) == KEYS[:-1] + (["breakdown"] if trace else []) + KEYS[-1:]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert "setup_s" in line["metrics"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench360/run.py", "--workload", "pair360.track-b8", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "bench360"), tmp_path / "bench360",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, "bench360/run.py", "--workload", "pair360.track-b8", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell", sorted(tiny.TINY))
def test_no_jax_module_in_a_run(tmp_path, cell):
    """A run in a fresh process: the harness itself refuses to print a
    result once jax, jaxlib, flax or rgbd360_tpu is loaded; here it prints."""
    code = (f"import sys; sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r}); import tiny; "
            f"rc, line = tiny.run_cell({str(tmp_path)!r}, {cell!r}); "
            "from bench360.lib.harness import forbidden_modules; "
            "print('RESULT', rc, line is not None, forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert "RESULT 0 True []" in proc.stdout, proc.stderr[-2000:]


def test_nothing_to_read_is_no_pass():
    """A stage reader whose brackets never appeared reads None, not 0 ms;
    a comparison the limits name that found no sample reads inf."""
    from types import SimpleNamespace

    from bench360.lib.compare import Worst
    from bench360.lib.harness import Bench

    bench = Bench(os.path.join(ROOT, "BENCHMARK.json"))
    ctx = SimpleNamespace(units=10, stages={"a renamed stage": 50.0}, counters={}, device_trace=None)
    for name in ("slam.loop_closure_ms", "frame.build_ms", "frame.planes_ms", "align.tracking_ms",
                 "photoicp.ms_per_iter", "photoicp.sweeps_per_pair", "gather_windowed_roofline",
                 "gather_full_roofline", "device.idle.pairs", "device.idle.slam"):
        assert bench.metric(name).read(ctx) is None, name
    worst = Worst("seen", "unseen")
    worst.add("seen", 0.0)
    worst.add("not named", 5.0)
    assert worst.values == {"seen": 0.0, "unseen": float("inf")}


def _shifted(pose: torch.Tensor, k: int = 0) -> torch.Tensor:
    pose = pose.clone()
    pose[k, 0, 3] += 0.01  # one answer off by 1 cm where it is produced
    return pose


def _pair_fault_answer(monkeypatch):
    from rgbd360_torch.parallel import batch

    real = batch.align_batch

    def off(*a, **k):
        res = real(*a, **k)
        return res._replace(pose=_shifted(res.pose))

    monkeypatch.setattr(batch, "align_batch", off)


def _pair_fault_half_batch(monkeypatch):
    """Half of the batch left out: those pairs come back at their guess."""
    from rgbd360_torch.parallel import batch

    real = batch.align_batch

    def half(gs, ds, gt, dt, guess, **k):
        n, b = gs.shape[0], gs.shape[0] // 2
        res = real(gs[:b], ds[:b], gt[:b], dt[:b], guess[:b], **k)
        res = res._replace(**{f: torch.cat([v, v[:n - b]]) for f, v in res._asdict().items()})
        return res._replace(pose=torch.cat([res.pose[:b], guess[b:]]))

    monkeypatch.setattr(batch, "align_batch", half)


def _slam_fault_align(monkeypatch):
    from rgbd360_torch.ops import photoicp

    real = photoicp.align_frames360

    def off(*a, **k):
        res = real(*a, **k)
        return res._replace(pose=_shifted(res.pose))

    monkeypatch.setattr(photoicp, "align_frames360", off)


def _slam_fault_panorama(monkeypatch):
    from rgbd360_torch.ops import stitch

    real = stitch.stitch_with_maps

    def one_pixel(*a, **k):
        rgb, depth = real(*a, **k)
        rgb = rgb.clone()
        rgb[100, 100, 0] ^= 1
        return rgb, depth

    monkeypatch.setattr(stitch, "stitch_with_maps", one_pixel)


def _slam_fault_planes(monkeypatch):
    """The plane layer drops one plane of each frame where it fits them."""
    from rgbd360_torch.core import plane_extraction

    real = plane_extraction._fit_from_stats_buffer

    def one_less(*a, **k):
        pbmap, local = real(*a, **k)
        pbmap.planes = pbmap.planes[:-1]
        return pbmap, local

    monkeypatch.setattr(plane_extraction, "_fit_from_stats_buffer", one_less)


@pytest.mark.parametrize("cell,fault", [
    ("pair360.tiny", _pair_fault_answer),
    ("pair360.tiny", _pair_fault_half_batch),
    ("slam360.tiny", _slam_fault_align),
    ("slam360.tiny", _slam_fault_panorama),
    ("slam360.tiny", _slam_fault_planes),
])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line = tiny.run_cell(str(tmp_path), cell, seconds=seconds(cell))
    assert rc == 0 and line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_a_pose_graph_fault_is_not_correct(tmp_path, monkeypatch):
    """The graph's answer altered where it is produced: the SLAM driver's
    check over a recorded optimization (a tiny run reaches none)."""
    from bench360.lib import harness
    from rgbd360_torch.core.graph_optimizer import GraphOptimizer

    bench_json, bench_dir = tiny.make_bench(str(tmp_path))
    bench = harness.Bench(bench_json, bench_dir)
    args = harness.parse_args(["--workload", "slam360.arc20", "--seed", "3", "--seconds", "2"])
    workload = dict(bench.workload("slam360.arc20"), check={"frames": 0, "tracking": 0, "loop_closure": 0})
    ctx = harness.Context(args, bench.cell("slam360.arc20"), bench.config("slam360"), workload,
                          torch.device("cpu"), str(tmp_path))
    drv = bench.driver("slam").Driver(ctx)
    real = GraphOptimizer.optimize_graph

    def off(self, *a, **k):
        out = real(self, *a, **k)
        self.vertices[-1] = self.vertices[-1].copy()
        self.vertices[-1][0, 3] += 0.01
        return out

    monkeypatch.setattr(GraphOptimizer, "optimize_graph", off)
    with drv.rec.installed():
        drv.rec.on = True
        g = GraphOptimizer(robust=True)
        step = np.eye(4)
        step[0, 3] = 0.2
        for k in range(3):
            g.add_vertex(np.linalg.matrix_power(step, k))
        g.add_edge(0, 1, step, np.eye(6))
        g.add_edge(1, 2, step, np.eye(6))
        g.optimize_graph()
    drv.calib_root, drv.seq = str(tmp_path), str(tmp_path)
    drv.rec.frames.append((1, torch.zeros(1), torch.zeros(1)))
    checks = {name: (value, limit) for name, value, limit in drv.check()}
    assert checks["graph_t_mm"][0] > checks["graph_t_mm"][1]
