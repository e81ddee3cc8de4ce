"""The port's tracer (rgbd360_torch/utils/timing.py) and what the port
records with it: spans (nesting, threads, the frame id, the bounded
buffer, the profiler's ranges, the Chrome trace), the stage brackets'
unchanged contract, the counter groups, the aligner's Gauss-Newton counts
(photoicp.GN) on the CPU exact route, the loop closer's funnel
(loop_closure.LC) on the room frames of tests/test_torch_loop_closure.py,
and the SLAM app's per-frame spans. The card's half (every host sync of
align_frames360 counted) is tests/test_torch_cuda.py's
test_every_host_sync_of_the_aligner_is_counted.
"""

import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.core import loop_closure as t_lc  # noqa: E402
from rgbd360_torch.core.frame360 import Frame360 as TFrame  # noqa: E402
from rgbd360_torch.core.map360 import Map360  # noqa: E402
from rgbd360_torch.io.calib import Calib360 as TCalib  # noqa: E402
from rgbd360_torch.ops import photoicp as tp  # noqa: E402
from rgbd360_torch.ops import warp_gather as tw  # noqa: E402
from rgbd360_torch.parallel.batch import align_batch  # noqa: E402
from rgbd360_torch.utils import timing  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def traced():
    """Tracing on through stage_timing(True), with empty totals and buffer."""
    timing.reset_timing()
    timing.stage_timing(True)
    yield
    timing.stage_timing(False)
    timing.reset_timing()


def _by_name(name):
    return [s for s in timing.span_records() if s.name == name]


# -- spans ----------------------------------------------------------------------


def test_spans_nest_with_parents_and_inherit_the_frame(traced):
    with timing.span("frame", frame=7):
        with timing.span("stage a"):
            with timing.span("leaf", k=1):
                pass
        with timing.span("stage b", frame=8):
            pass
    (frame,), (a,), (leaf,), (b,) = (_by_name(n) for n in ("frame", "stage a", "leaf", "stage b"))
    assert frame.parent is None and a.parent == frame.id and leaf.parent == a.id and b.parent == frame.id
    assert leaf.attrs == {"k": 1, "frame": 7} and a.attrs == {"frame": 7} and b.attrs == {"frame": 8}
    assert frame.start_ns <= a.start_ns <= leaf.start_ns <= leaf.end_ns <= a.end_ns <= b.start_ns <= frame.end_ns
    # ended in order, innermost first
    assert [s.name for s in timing.span_records()] == ["leaf", "stage a", "stage b", "frame"]
    assert [n for n, _a, _b in timing.spans()] == ["leaf", "stage a", "stage b", "frame"]
    name, start, end = timing.spans()[-1]
    assert (start, end) == (frame.start_ns / 1e9, frame.end_ns / 1e9)


def test_each_thread_has_its_own_stack_and_a_frame_id_crosses_threads(traced):
    def worker():
        with timing.span("planes host fit", frame=3):
            with timing.span("fit inner"):
                pass

    with timing.span("frame", frame=3):
        th = threading.Thread(target=worker, name="planes-fit")
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with timing.span("main inner"):
            pass
    (frame,), (fit,), (inner,), (main_inner,) = (_by_name(n) for n in ("frame", "planes host fit", "fit inner",
                                                                       "main inner"))
    assert fit.parent is None and fit.thread == "planes-fit"  # not a child of the main thread's frame
    assert inner.parent == fit.id and inner.thread == "planes-fit"
    assert main_inner.parent == frame.id and frame.thread == threading.current_thread().name
    assert {s.attrs["frame"] for s in (frame, fit, inner, main_inner)} == {3}


def test_the_buffer_keeps_the_newest_spans(traced):
    n = timing.SPAN_CAPACITY + 10
    for k in range(n):
        with timing.span("s", k=k):
            pass
    records = timing.span_records()
    assert len(records) == timing.SPAN_CAPACITY
    assert [r.attrs["k"] for r in (records[0], records[-1])] == [10, n - 1]
    assert timing.timing_summary()["s"][1] == n  # the totals count every span


def test_off_records_nothing(monkeypatch):
    monkeypatch.setattr(timing, "_trace_path", None)
    timing.stage_timing(False)
    timing.reset_timing()
    assert not timing.tracing()
    calls = []
    with timing.span("x", frame=1) as a, timing.stage("y", sync=lambda: calls.append(1)) as b:
        pass
    assert a is b is timing._OFF
    assert timing.span_records() == [] and timing.timing_summary() == {} and calls == []


def test_stage_prints_and_sums_as_before(traced, capsys):
    calls = []
    with timing.stage("Dense alignment 360", sync=lambda: calls.append(1)):
        pass
    with timing.stage("Dense alignment 360"):
        pass
    with timing.span("not a stage"):
        pass
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(re.fullmatch(r"Dense alignment 360 took \d+\.\d\d ms", line) for line in out)
    assert calls == [1]
    summary = timing.timing_summary()
    total, count, mean = summary["Dense alignment 360"]
    assert count == 2 and mean == total / 2
    assert summary["not a stage"][1] == 1
    timing.reset_timing()
    assert timing.timing_summary() == {} and timing.span_records() == []


def test_under_the_profiler_spans_are_ranges_beside_the_ops(monkeypatch):
    """No stage timing, no RGBD360_TRACE: a recording profiler turns
    tracing on, and each span is a record_function range on its clock."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(timing, "_trace_path", None)
    timing.stage_timing(False)
    timing.reset_timing()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timing.tracing()
        with timing.span("align", pairs=2):
            with timing.stage("GN iteration"):
                torch.ones(8).add_(1.0)
    names = {e.name for e in prof.events()}
    assert {"align", "GN iteration"} <= names
    assert [s.name for s in timing.span_records()] == ["GN iteration", "align"]
    timing.reset_timing()


def test_the_chrome_trace_loads_as_json(traced, tmp_path):
    with timing.span("frame", frame=1):
        with timing.span("align", pairs=2):
            pass
    path = tmp_path / "trace.json"
    timing.write_trace(str(path))
    doc = json.load(open(path))
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert spans["align"]["args"]["parent"] == spans["frame"]["args"]["id"]
    assert spans["align"]["args"]["frame"] == 1 and spans["align"]["dur"] >= 0
    assert spans["frame"]["ts"] <= spans["align"]["ts"]
    counters = {e["name"]: e["args"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert set(counters["photoicp.GN"]) == {"iterations", "syncs", "wait_ns", "host_ns"}
    assert "warp_gather.LAUNCHES" in counters and "loop_closure.LC" in counters


def test_rgbd360_trace_writes_the_file_at_exit(tmp_path):
    path = tmp_path / "trace.json"
    code = ("from rgbd360_torch.utils import timing\n"
            "with timing.span('frame', frame=1):\n"
            "    with timing.stage('planes join (thread)'):\n"
            "        pass\n")
    env = dict(os.environ, RGBD360_TRACE=str(path))
    env.pop("RGBD360_PRINT_TIMINGS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == ""  # tracing alone prints nothing
    events = json.load(open(path))["traceEvents"]
    assert [e["name"] for e in events if e["ph"] == "X"] == ["planes join (thread)", "frame"]


# -- counters -------------------------------------------------------------------


def test_counter_groups_are_registered_and_snapshotted():
    groups = timing.counters()
    assert {"warp_gather.LAUNCHES", "photoicp.SWEEPS", "photoicp.GN", "loop_closure.LC"} <= set(groups)
    assert groups["photoicp.SWEEPS"] == tp.SWEEPS and groups["photoicp.SWEEPS"] is not tp.SWEEPS
    assert timing._groups["warp_gather.LAUNCHES"] is tw.LAUNCHES


def test_counts_from_many_threads_are_not_lost():
    """More threads than cores, a short switch interval: every count and
    every host_sync of its own scope lands."""
    counts = {"n": 0}
    scopes = [{"syncs": 0, "wait_ns": 0} for _ in range(16)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            with timing.sync_scope(scopes[k], "GN sync"):
                for _ in range(2000):
                    timing.count(counts, "n")
                    timing.host_sync(int, 1)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["n"] == 16 * 2000
    assert all(s["syncs"] == 2000 for s in scopes)
    assert timing.host_sync(int, 1) == 1  # outside a scope: run, not counted
    assert all(s["syncs"] == 2000 for s in scopes)


def _small_pairs(b=2, h=80, w=480):
    g = np.load(os.path.join(ROOT, "tests", "golden", "pair_1_10.npz"))
    rows = np.linspace(0, g["gray_src_u8"].shape[0] - 1, h).astype(int)
    cols = np.linspace(0, g["gray_src_u8"].shape[1] - 1, w).astype(int)
    img = lambda key, scale: torch.from_numpy(
        np.stack([g[key][np.ix_(rows, cols)].astype(np.float32) * scale] * b))
    return (img("gray_src_u8", 1 / 255.0), img("depth_src_mm", 0.001), img("gray_trg_u8", 1 / 255.0),
            img("depth_trg_mm", 0.001), torch.eye(4).expand(b, 4, 4).contiguous())


@pytest.mark.parametrize("n_levels", [2, 3])
def test_gn_counts_the_loop_bodies_and_one_read_per_loop_test(traced, n_levels):
    """On the CPU exact route each level sweeps once before its loop and
    once per loop body, and reads its loop test once per body plus the
    test that ends it; uploads to the CPU are no syncs."""
    tp.reset_sweep_counts()
    assert tp.GN == {"iterations": 0, "syncs": 0, "wait_ns": 0, "host_ns": 0}
    res = align_batch(*_small_pairs(), n_levels=n_levels)
    gn = dict(tp.GN)
    bodies = tp.SWEEPS["exact"] - n_levels
    assert gn["iterations"] == bodies > 0
    assert gn["syncs"] == bodies + n_levels
    assert gn["host_ns"] >= gn["wait_ns"] > 0
    assert (res.num_iterations.max(dim=0).values.sum() <= bodies).item()
    # the spans: one align, a level each, an iteration per body, a sync per read
    (align,) = _by_name("align")
    assert align.attrs == {"pairs": 2, "full_coverage": False}
    levels = _by_name("align level")
    assert sorted(s.attrs["level"] for s in levels) == list(range(n_levels))
    assert all(s.parent == align.id for s in levels)
    assert len(_by_name("GN iteration")) == bodies and len(_by_name("GN sync")) == bodies + n_levels
    tp.reset_sweep_counts()
    assert set(tp.GN.values()) == {0} and set(tp.SWEEPS.values()) == {0}


# -- the loop closer and the SLAM app -------------------------------------------


def _pose(x=0.0, y=0.0, z=0.0):
    p = np.eye(4)
    p[:3, 3] = (x, y, z)
    return p


# tests/test_torch_loop_closure.py's REL1 and REL2
REL1 = _pose(y=0.25, z=-0.1)
REL2 = _pose(x=0.1, y=-0.2)


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """The port's room frames at the origin, REL2 and REL1 on the CPU."""
    root = str(tmp_path_factory.mktemp("lc_room"))
    rig.write_calib_root(root)
    calib = TCalib.load(root)
    frames = []
    for i, pose in enumerate((np.eye(4), REL2, REL1)):
        raw = rig.room_capture(pose, calib.Rt, obstacles=())
        f = TFrame(calib, i, "cpu")
        f.rgb, f.depth_raw_mm = torch.from_numpy(raw.rgb), torch.from_numpy(raw.depth)
        f.depth_undistorted_m = f.depth_raw_mm.to(torch.float32) * 0.001
        f.stitch_spherical_image()
        f.get_planes(need_inliers=False)
        frames.append((f, pose))
    return frames


@pytest.mark.parametrize("kfs, pairs", [((0, 1, 2), 2), ((0, 2), 1)])
def test_lc_counts_agree_with_the_refinements_and_the_closures(traced, room, kfs, pairs):
    """The scenarios of tests/test_torch_loop_closure.py: two candidates
    take one batched refinement of 2 pairs, one takes the facade."""
    world = Map360()
    for k in kfs:
        world.add_keyframe(room[k][0], room[k][1])
    world.trajectory_increments = [8.0 * i for i in range(len(kfs))]
    lc = t_lc.LoopClosure360(world, None, device="cpu")
    before = dict(t_lc.LC)
    accepted = lc.process_new_keyframe(len(kfs) - 1)
    delta = {k: t_lc.LC[k] - before[k] for k in before}
    assert lc.refinements == [pairs] and accepted == len(lc.accepted) == pairs
    assert delta == {"keyframes": 1, "candidates": pairs, "prefilter_kept": pairs, "pbmap_kept": pairs,
                     "refinements": len(lc.refinements), "refined_pairs": sum(lc.refinements),
                     "accepted": len(lc.accepted)}
    (refine,) = _by_name("LC dense refinement")
    assert refine.attrs == {"pairs": pairs}
    (align,) = _by_name("align")
    assert align.attrs["pairs"] == pairs and align.attrs["full_coverage"] is True
    assert refine.start_ns <= align.start_ns <= align.end_ns <= refine.end_ns


def test_the_slam_app_spans_each_frame_on_both_threads(traced, tmp_path, capsys):
    from rgbd360_torch.apps import sphere_graph_slam

    rts = rig.write_calib_root(str(tmp_path / "calib"))
    rig.write_sequence(str(tmp_path / "seq"), rts, frames=3)
    session = sphere_graph_slam.run([str(tmp_path / "seq"), "--calib-root", str(tmp_path / "calib"),
                                     "--device", "cpu"])
    capsys.readouterr()
    assert len(session.world) == 3
    frames = _by_name("frame")
    assert [s.attrs["frame"] for s in frames] == [1, 2, 3]
    by_id = {s.id: s for s in timing.span_records()}
    for s in _by_name("Dense alignment 360"):
        assert by_id[s.parent].name == "frame" and s.attrs["frame"] == by_id[s.parent].attrs["frame"]
    for name in ("planes collect (sync)", "planes host fit"):
        spans = _by_name(name)
        assert [s.attrs["frame"] for s in spans] == [1, 2, 3] and {s.thread for s in spans} == {"planes-fit"}
    assert sorted(s.attrs["frame"] for s in _by_name("planes join (thread)")) == [1, 2, 3]
    assert sorted(s.attrs["frame"] for s in _by_name("planes dispatch")) == [1, 2, 3]
    # the frame program inherits the frame it builds from "planes dispatch"
    built = _by_name("Frame360.build_device_fused")
    assert sorted(s.attrs["frame"] for s in built) == [1, 2, 3]
