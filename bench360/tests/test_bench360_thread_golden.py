"""The threaded SLAM cell (slam360thread.loop40, drivers/slamthread.py) and
the golden pair cell (pair360.golden-b8, drivers/golden.py), added as
files only: the spec accepts the configuration, both cells and the three
slam.lc_* readers; the frozen pair under bench360/data/ is the repository's
golden pair, array for array; the guesses are what the traffic states; the
readers read the thread's spans and counts and None without them; a tiny
cell of each runs on the CPU and is not correct under a fault planted
where the program produces its answer; a program without the thread's
counters fails in set-up; on the card, the control (the reference in
TF32) and the whole-loop faults are not correct.

    python -m pytest bench360/tests/test_bench360_thread_golden.py -q
    python -m pytest bench360/tests/test_bench360_thread_golden.py -m cuda -s -q   # on the card
"""

import contextlib
import io
import json
import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tiny  # noqa: E402
from bench360.lib import harness  # noqa: E402

ROOT = tiny.ROOT
BENCH = harness.Bench(os.path.join(ROOT, "BENCHMARK.json"))
SPEC = BENCH.spec
NEW_CELLS = ["slam360thread.loop40", "pair360.golden-b8"]
READERS = ["slam.lc_thread_ms", "slam.lc_queue_depth", "slam.lc_drain_ms"]


# -- the spec --------------------------------------------------------------------


def test_the_configuration_cells_and_readers_are_found_by_name():
    (entry,) = [c for c in SPEC["configs"] if c["name"] == "slam360thread"]
    cfg, base = BENCH.config("slam360thread"), BENCH.config("slam360")
    assert cfg["source"] == entry["source"] != base["source"] and cfg["reduced"] == entry["reduced"] == base["reduced"]
    assert cfg["lc_thread"] is True
    assert {k: v for k, v in cfg.items() if k in base and k not in ("name", "source", "deployment")} == {
        k: v for k, v in base.items() if k not in ("name", "source", "deployment")}
    assert SPEC["configs"][-1] is entry and [w["name"] for w in SPEC["workloads"][-2:]] == NEW_CELLS
    for name in NEW_CELLS:
        cell = BENCH.cell(name)
        assert cell["chips"] == 1 and len(cell["why"]) <= 200 and BENCH.per_layer(name)
    thread, loop40 = BENCH.workload("slam360thread.loop40"), BENCH.workload("slam360.loop40")
    assert thread["driver"] == "slamthread"
    same = ("circle", "calibration_seed", "use_frames", "warmup_frames", "trace_seconds", "check")
    assert {k: thread[k] for k in same} == {k: loop40[k] for k in same}
    assert thread["expect"] == loop40["expect"]
    assert thread["limits"] == dict(loop40["limits"], lc_searched=0, lc_dropped=0, lc_undrained=0)
    assert {m["name"] for m in BENCH.end_to_end("slam360thread.loop40")} == {"frame_ms_p50", "frame_ms_p90", "setup_s"}
    assert {m["name"] for m in BENCH.end_to_end("pair360.golden-b8")} == {"pairs_per_s", "setup_s"}
    assert "slam.loop_closure_ms" not in {m["name"] for m in BENCH.per_layer("slam360thread.loop40")}
    spec = {m["name"]: m for m in SPEC["per_layer"]}
    for name in READERS:
        m = spec[name]
        assert m["layer"] == "SLAM back end (thread)" and m["moves"] == "frame_ms_p90"
        assert m["workloads"] == ["slam360thread.loop40"] and callable(BENCH.metric(name).read)
    assert BENCH.workload("pair360.golden-b8")["driver"] == "golden"


def test_the_frozen_pair_is_the_golden_pair():
    frozen = np.load(os.path.join(ROOT, "bench360", "data", "pair_1_10.npz"))
    golden = np.load(os.path.join(ROOT, "tests", "golden", "pair_1_10.npz"))
    assert sorted(frozen.files) == sorted(["gray_src_u8", "gray_trg_u8", "depth_src_mm", "depth_trg_mm"])
    for key in frozen.files:
        assert frozen[key].dtype == golden[key].dtype and frozen[key].tobytes() == golden[key].tobytes(), key


def test_the_guesses_are_the_traffics():
    golden = BENCH.driver("golden")
    w = BENCH.workload("pair360.golden-b8")
    g = golden.perturbed_guesses(w)
    assert g.shape == (16, 4, 4) and g.dtype == np.float32 and np.array_equal(g, golden.perturbed_guesses(w))
    assert np.abs(g[:, :3, 3]).max() <= 0.03 and np.abs(g[:, :3, 3]).max() > 0.02
    rot = g[:, :3, :3].astype(np.float64)
    assert np.allclose(rot @ rot.transpose(0, 2, 1), np.eye(3), atol=1e-6)
    angle = np.degrees(np.arccos(np.clip((np.trace(rot, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert angle.max() <= np.sqrt(3.0) * 1.0 and angle.max() > 0.5
    assert np.array_equal(g[:, 3], np.tile([0, 0, 0, 1], (16, 1)))


# -- the readers -----------------------------------------------------------------


def _ctx(units=0, stages=None, counters=None):
    return SimpleNamespace(units=units, stages=stages or {}, counters=counters or {}, device_trace=None)


def test_the_readers_read_the_threads_spans_and_counts():
    ctx = _ctx(units=40, stages={"loop closure (thread)": 2000.0, "Loop closure": 1e6},
               counters={"lc_taken": 39, "lc_queued_at_take": 78, "lc_drain_ns": 900_000_000, "lc_sessions": 3})
    read = lambda name: BENCH.metric(name).read(ctx)
    assert read("slam.lc_thread_ms") == pytest.approx(50.0)
    assert read("slam.lc_queue_depth") == pytest.approx(2.0)
    assert read("slam.lc_drain_ms") == pytest.approx(300.0)


def test_the_readers_read_none_without_the_thread():
    """The synchronous cells: no thread span, no thread counts."""
    ctx = _ctx(units=40, stages={"Loop closure": 100.0, "LC dense refinement": 50.0})
    for name in READERS:
        assert BENCH.metric(name).read(ctx) is None, name


# -- tiny cells on the CPU ----------------------------------------------------------

TINY = {
    # (the cell it copies, the parameters it changes, the limits it drops)
    "pair360.goldentiny": ("pair360.golden-b8", {"guesses": 4, "batch": 2, "warmup_batches": 1, "check_batches": 2}, ()),
    "slam360thread.tiny": ("slam360thread.loop40",
                           {"use_frames": 3, "warmup_frames": 2, "check": {"frames": 2, "tracking": 2, "loop_closure": 1},
                            "expect": {"keyframes": 3, "planes": 40, "loop_closures": 0, "lc_batched": 0}},
                           ("graph_t_mm", "graph_r_deg", "ate_mm")),
}
SECONDS = {"pair360.goldentiny": 2, "slam360thread.tiny": 9}


def run_tiny(tmp: str, cell: str, trace: int = 0, seed: int = 2_200_000_001, config=None, drop=(), **params):
    """(exit code, last line) of one tiny cell, added as files to a copy of
    the benchmark; ``params`` change its traffic further, ``drop`` leaves
    out more of its limits, ``config`` changes its configuration's keys in
    the copy."""
    bench_json, bench_dir = tiny.make_bench(tmp)
    if config:
        path = os.path.join(bench_dir, "configs", cell.split(".")[0] + ".json")
        with open(path) as f:
            cfg = dict(json.load(f), **config)
        with open(path, "w") as f:
            json.dump(cfg, f)
    like, change, _drop = TINY[cell]
    w = json.load(open(os.path.join(bench_dir, "workloads", like + ".json")))
    w.update(change, trace_seconds=1)
    w.update(params)
    w["limits"] = {k: v for k, v in w["limits"].items() if k not in TINY[cell][2] + tuple(drop)}
    with open(os.path.join(bench_dir, "workloads", cell + ".json"), "w") as f:
        json.dump(w, f)
    spec = json.load(open(bench_json))
    config, traffic = cell.split(".")
    spec["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                              "why": "a CPU test of a new cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(cell)
    with open(bench_json, "w") as f:
        json.dump(spec, f)
    torch.set_num_threads(2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(SECONDS[cell] + 8 * trace),
                          "--trace", str(trace)], bench_json=bench_json, bench_dir=bench_dir, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_tiny_cell_runs_and_is_correct(tmp_path, cell, trace):
    rc, line = run_tiny(str(tmp_path), cell, trace=trace)
    assert rc == 0 and line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    if cell.startswith("slam360thread"):
        for name in ("lc_searched", "lc_dropped", "lc_undrained", "loop_closures", "lc_batched", "keyframes"):
            assert line["checks"][name]["value"] == 0.0, name
    if trace and cell.startswith("slam360thread"):
        metrics = line["metrics"]
        assert metrics["slam.lc_thread_ms"]["value"] > 0 and metrics["slam.lc_drain_ms"]["value"] > 0
        assert metrics["slam.lc_queue_depth"]["value"] >= 0 and metrics["frame.build_ms"]["value"] > 0
    elif trace:
        assert line["metrics"]["photoicp.sweeps_per_pair"]["value"] > 0
    else:
        assert "setup_s" in line["metrics"]


def test_a_golden_answer_off_is_not_correct(tmp_path, monkeypatch):
    """One pair's answer off by 1 cm where align_batch produces it."""
    from rgbd360_torch.parallel import batch

    real = batch.align_batch

    def off(*a, **k):
        res = real(*a, **k)
        pose = res.pose.clone()
        pose[0, 0, 3] += 0.01
        return res._replace(pose=pose)

    monkeypatch.setattr(batch, "align_batch", off)
    rc, line = run_tiny(str(tmp_path), "pair360.goldentiny")
    assert rc == 0 and line["correct"] is False and line["checks"]["align_t_mm"]["value"] > 5.0


def _held_until_stop(monkeypatch, on_stop=None):
    """Each loop closer's thread holds its first keyframe until the app
    stops it, so that the others wait in the queue and every closure comes
    after the last frame; ``on_stop(self, stop)`` stands in for the stop."""
    from rgbd360_torch.core.loop_closure import LoopClosure360

    search, stop = LoopClosure360.process_new_keyframe, LoopClosure360.stop
    stopping = lambda lc: lc.__dict__.setdefault("_held", threading.Event())

    def held(self, kf_id):
        stopping(self).wait(timeout=120)
        return search(self, kf_id)

    def held_stop(self):
        stopping(self).set()
        return (on_stop or (lambda lc, real: real(lc)))(self, stop)

    monkeypatch.setattr(LoopClosure360, "process_new_keyframe", held)
    monkeypatch.setattr(LoopClosure360, "stop", held_stop)


def test_a_stop_that_drops_the_queue_is_not_correct(tmp_path, monkeypatch):
    """The loop closer's stop as it was: the keyframes still queued when it
    is called are never searched."""
    from rgbd360_torch.core.loop_closure import LoopClosure360

    take = LoopClosure360._take

    def dropped_after_stop(self, item):
        if self.__dict__.get("_stopped"):
            return
        take(self, item)

    def dropping_stop(self, real):
        self._stopped = True
        real(self)

    _held_until_stop(monkeypatch, dropping_stop)
    monkeypatch.setattr(LoopClosure360, "_take", dropped_after_stop)
    rc, line = run_tiny(str(tmp_path), "slam360thread.tiny")
    assert rc == 0 and line["correct"] is False and line["checks"]["lc_searched"]["value"] > 0


@pytest.mark.parametrize("drain_lost", [False, True])
def test_closures_after_the_last_frame_are_drained(tmp_path, monkeypatch, drain_lost):
    """The thread, held until the stop, accepts its closures after the last
    frame (a 0.3 m trajectory gap, cut from 6 m so that three frames close
    a loop): the app's final drain puts them in the last graph
    optimization, and without it (the fault) the run is not correct."""
    from rgbd360_torch.core import loop_closure

    def undrained_stop(self, real):
        real(self)
        self.connections_lc.clear()

    monkeypatch.setattr(loop_closure, "MIN_TRAJECTORY_GAP", 0.3)
    _held_until_stop(monkeypatch, undrained_stop if drain_lost else None)
    # the counts of a 3-frame session at this gap are no sound run's: not compared
    rc, line = run_tiny(str(tmp_path), "slam360thread.tiny", config={"min_trajectory_gap_m": 0.3},
                        drop=("loop_closures", "lc_batched"))
    assert rc == 0 and line["correct"] is (not drain_lost)
    assert (line["checks"]["lc_undrained"]["value"] > 0) is drain_lost


def test_a_program_without_the_threads_counters_fails_in_setup(tmp_path, monkeypatch):
    """The parent of this cell: no loop_closure.THREAD. set-up raises before
    it ray-casts anything."""
    from rgbd360_torch.apps import sphere_graph_slam  # noqa: F401  (imported while it can be)
    from rgbd360_torch.core import loop_closure

    monkeypatch.delattr(loop_closure, "THREAD")
    with pytest.raises(RuntimeError, match="THREAD"):
        run_tiny(str(tmp_path), "slam360thread.tiny")


# -- on the card -------------------------------------------------------------------

SEEDS = [2_147_483_700, 3_000_000_001, 4_100_000_003]
WINDOW_S = {"pair360.golden-b8": 5, "slam360thread.loop40": 30}


def bench_run(cell: str, seed: int, control: bool = False) -> dict:
    if not torch.cuda.is_available():
        pytest.skip("the control and the faults run at the cells' own size on a CUDA device")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(WINDOW_S[cell]), "--trace", "0"],
                         bench_json=os.path.join(ROOT, "BENCHMARK.json"), control=control)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", NEW_CELLS)
def test_control_is_not_correct(cell, seed):
    line = bench_run(cell, seed, control=True)
    print(f"control {cell} seed {seed}: {json.dumps(line['checks'])}")
    assert line["correct"] is False


def _skip_refine_batch(monkeypatch):
    from rgbd360_torch.core.loop_closure import LoopClosure360

    monkeypatch.setattr(LoopClosure360, "_refine_batch", lambda self, new_kf, survivors: [])


def _graph_unchanged(monkeypatch):
    from rgbd360_torch.core.graph_optimizer import GraphOptimizer

    monkeypatch.setattr(GraphOptimizer, "optimize_graph", lambda self, iterations=10, lam=1e-6: 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [_skip_refine_batch, _graph_unchanged])
def test_a_fault_of_a_whole_threaded_loop_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = bench_run("slam360thread.loop40", SEEDS[0])
    print(f"fault {fault.__name__} slam360thread.loop40 seed {SEEDS[0]}: {json.dumps(line['checks'])}")
    assert line["correct"] is False
