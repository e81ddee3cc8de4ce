"""The robot-frame cell (robot8.track-b8, drivers/rigpairs.py) and the
batch-1 pair cell (pair360.track-b1), added as files only: the spec
accepts the configuration, both cells and the four pinhole.* readers; the
plain reference of the robot-frame registration (reference/pinhole.py)
reads the raw captures as the program does and registers a small pair as
it does; the readers read the program's photoicp_pinhole counters and None
without them; a tiny robot-frame cell runs on the CPU, is not correct
under a fault, and a program without align_batch_rig fails in set-up; on
the card, the control (the reference in TF32) is not correct in either
new cell.

    python -m pytest bench360/tests/test_bench360_rig.py -q
    python -m pytest bench360/tests/test_bench360_rig.py -m cuda -s -q   # the control, on the card
"""

import contextlib
import io
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tiny  # noqa: E402
from bench360.lib import harness, rig  # noqa: E402
from bench360.reference import frames as ref_frames  # noqa: E402
from bench360.reference import pinhole as ref_pinhole  # noqa: E402

ROOT = tiny.ROOT
BENCH = harness.Bench(os.path.join(ROOT, "BENCHMARK.json"))
SPEC = BENCH.spec
NEW_CELLS = ["robot8.track-b8", "pair360.track-b1"]
READERS = ["pinhole.ms_per_iter", "pinhole.sweeps_per_batch", "pinhole.syncs_per_iter", "pinhole.wait_ms_per_iter"]


# -- the spec --------------------------------------------------------------------


def test_the_configuration_cells_and_readers_are_found_by_name():
    (entry,) = [c for c in SPEC["configs"] if c["name"] == "robot8"]
    cfg = BENCH.config("robot8")
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == ["dataset"]
    assert (cfg["sensors"], cfg["sensor_width"], cfg["sensor_height"], cfg["pyramid_levels"]) == (8, 320, 240, 4)
    assert SPEC["configs"][-1] is entry and [w["name"] for w in SPEC["workloads"][-2:]] == NEW_CELLS
    for name in NEW_CELLS:
        cell = BENCH.cell(name)
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        assert "pairs_per_s" in {m["name"] for m in BENCH.end_to_end(name)}
        assert {m["name"] for m in BENCH.per_layer(name)} >= {"device.idle.pairs"}
    assert BENCH.workload("robot8.track-b8")["driver"] == "rigpairs"
    b1, b8 = BENCH.workload("pair360.track-b1"), BENCH.workload("pair360.track-b8")
    assert b1 == dict(b8, batch=1)
    spec = {m["name"]: m for m in SPEC["per_layer"]}
    for name in READERS:
        m = spec[name]
        assert m["layer"] == "aligner (robot frame)" and m["moves"] == "pairs_per_s"
        assert m["workloads"] == ["robot8.track-b8"] and callable(BENCH.metric(name).read)
    assert {m["name"] for m in BENCH.per_layer("pair360.track-b1")} >= {
        "photoicp.ms_per_iter", "photoicp.sweeps_per_pair", "gather_windowed_roofline", "photoicp.graph_share"}


# -- the plain reference ---------------------------------------------------------


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """Two captures 6 deg apart through the frozen generator, and their calibration root."""
    tmp = str(tmp_path_factory.mktemp("rig_room"))
    rts = rig.write_calib_root(os.path.join(tmp, "calib"), 0)
    paths = rig.write_captures(os.path.join(tmp, "seq"), rig.circle_poses(2, 6.0, 0.8), [0, 1], rts, 1)
    return tmp, paths


def test_the_reference_reads_the_captures_as_the_program(room):
    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.io.calib import Calib360
    from rgbd360_torch.ops.image import gray_f32

    tmp, paths = room
    calib = Calib360.load(os.path.join(tmp, "calib"))
    rt, _inv, cam = calib.device_extrinsic_arrays("cpu")
    assert np.array_equal(ref_pinhole.extrinsics(os.path.join(tmp, "calib")), rt.numpy())
    assert np.array_equal(ref_frames.camera_matrix(), cam.numpy())
    for k, p in enumerate(paths):
        f = Frame360(calib, k + 1, "cpu")
        f.load_frame(p)
        gray, depth = ref_pinhole.sensor_input(p, "cpu")
        assert torch.equal(gray, gray_f32(f.rgb)) and torch.equal(depth, f.depth_raw_mm.to(torch.float32) * 0.001)


def test_the_reference_registers_a_small_pair_as_the_program(room):
    """The two captures at a quarter of their size (60 x 80, the camera
    matrix scaled), 3 levels: the program's batch of the pair and its
    reverse equals the reference pair by pair, bit for bit."""
    from rgbd360_torch.parallel.batch import align_batch_rig

    tmp, paths = room
    small = [tuple(x[:, ::4, ::4].contiguous() for x in ref_pinhole.sensor_input(p, "cpu")) for p in paths]
    k = ref_frames.camera_matrix() * np.float32(0.25)
    k[2, 2] = 1.0
    rts = ref_pinhole.extrinsics(os.path.join(tmp, "calib"))
    order = [(1, 0), (0, 1)]  # (source, target)
    stack = lambda part, side: torch.stack([small[o[side]][part] for o in order])
    prog = align_batch_rig(stack(0, 0), stack(1, 0), stack(0, 1), stack(1, 1), torch.from_numpy(rts),
                           torch.from_numpy(k), torch.eye(4).expand(2, 4, 4), n_levels=3)
    for b, (s, t) in enumerate(order):
        ref = ref_pinhole.register(*small[s], *small[t], rts, k, np.eye(4, dtype=np.float32), n_levels=3)
        assert np.array_equal(prog.pose[b].numpy(), ref["pose"]) and np.array_equal(prog.hessian[b].numpy(), ref["hessian"])
        assert prog.num_iterations[b].tolist() == ref["iters"].tolist() and bool(prog.ill_posed[b]) == ref["ill"]
        assert float(prog.error[b]) == ref["error"] and float(prog.av_depth_residual[b]) == ref["av_depth"]
    # the rig moved ~8.4 cm between the captures
    assert 0.05 < np.linalg.norm(prog.pose[0, :3, 3].numpy()) < 0.12


# -- the readers -----------------------------------------------------------------


def _ctx(counters=None):
    return SimpleNamespace(units=0, stages={}, counters=counters or {}, device_trace=None)


def test_the_readers_read_the_rig_counters(monkeypatch):
    from rgbd360_torch.ops import photoicp_pinhole

    monkeypatch.setattr(photoicp_pinhole, "GN", {"iterations": 50, "syncs": 70, "wait_ns": 150_000_000,
                                                  "host_ns": 900_000_000, "pair_retries": 90})
    ctx = _ctx({"rig_sweeps": 300, "rig_batches": 10, "rig_iterations": 120.0, "rig_align_s": 1.8})
    read = lambda name: BENCH.metric(name).read(ctx)
    assert read("pinhole.syncs_per_iter") == pytest.approx(1.4)
    assert read("pinhole.wait_ms_per_iter") == pytest.approx(3.0)
    assert read("pinhole.sweeps_per_batch") == pytest.approx(30.0)
    assert read("pinhole.ms_per_iter") == pytest.approx(15.0)


@pytest.mark.parametrize("gn", [None, {"iterations": 0, "syncs": 0, "wait_ns": 0, "host_ns": 0, "pair_retries": 0}])
def test_the_readers_read_none_without_the_counters(monkeypatch, gn):
    """A program without the group (the parent of the cell) or a run with
    no loop body; the spherical pair driver's counters are not the rig's."""
    from rgbd360_torch.ops import photoicp_pinhole

    if gn is None:
        monkeypatch.delattr(photoicp_pinhole, "GN")
    else:
        monkeypatch.setattr(photoicp_pinhole, "GN", gn)
    ctx = _ctx({"sweeps": 30, "gn_iterations": 12.0, "align_s": 0.2})
    for name in READERS:
        assert BENCH.metric(name).read(ctx) is None, name


# -- a tiny robot-frame cell on the CPU --------------------------------------------

TINY = {"circle": {"frames": 3, "deg_per_step": 6.0, "radius": 0.8}, "batch": 2, "warmup_batches": 1,
        "check_batches": 2, "trace_seconds": 1}


def _run_tiny(tmp: str, trace: int = 0, seconds: float = 4, seed: int = 2_200_000_001):
    """(exit code, last line) of robot8.tiny, robot8.track-b8 at 3 frames
    and batch 2, added as files to a copy of the benchmark."""
    bench_json, bench_dir = tiny.make_bench(tmp)
    w = dict(json.load(open(os.path.join(bench_dir, "workloads", "robot8.track-b8.json"))), **TINY)
    with open(os.path.join(bench_dir, "workloads", "robot8.tiny.json"), "w") as f:
        json.dump(w, f)
    spec = json.load(open(bench_json))
    spec["workloads"].append({"name": "robot8.tiny", "config": "robot8", "traffic": "tiny", "chips": 1,
                              "why": "a CPU test of the robot-frame cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "robot8.track-b8" in m.get("workloads", ()):
            m["workloads"].append("robot8.tiny")
    with open(bench_json, "w") as f:
        json.dump(spec, f)
    torch.set_num_threads(2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(["--workload", "robot8.tiny", "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", str(trace)], bench_json=bench_json, bench_dir=bench_dir, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_robot_frame_cell_runs_and_is_correct(tmp_path, trace):
    rc, line = _run_tiny(str(tmp_path), trace=trace, seconds=4 + 6 * trace)
    assert rc == 0 and line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == {"align_t_mm", "align_r_deg", "align_stats", "align_iters"}
    assert all(c["value"] == 0.0 for c in line["checks"].values())
    if trace:
        for name in READERS:
            assert line["metrics"][name]["value"] > 0, name
        assert line["metrics"]["pinhole.syncs_per_iter"]["value"] >= 1.0
    else:
        assert set(line["metrics"]) == {"pairs_per_s", "setup_s"}


def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, monkeypatch):
    """One pair's answer off by 1 cm where align_batch_rig produces it."""
    from rgbd360_torch.parallel import batch

    real = batch.align_batch_rig

    def off(*a, **k):
        res = real(*a, **k)
        pose = res.pose.clone()
        pose[0, 0, 3] += 0.01
        return res._replace(pose=pose)

    monkeypatch.setattr(batch, "align_batch_rig", off)
    rc, line = _run_tiny(str(tmp_path))
    assert rc == 0 and line["correct"] is False and line["checks"]["align_t_mm"]["value"] > 5.0


def test_a_program_without_the_batched_rig_entry_fails_in_setup(tmp_path, monkeypatch):
    """The parent of this cell: no align_batch_rig. set-up raises before it
    ray-casts anything."""
    from rgbd360_torch.parallel import batch

    monkeypatch.delattr(batch, "align_batch_rig")
    with pytest.raises(RuntimeError, match="align_batch_rig"):
        _run_tiny(str(tmp_path))


# -- the control, on the card ---------------------------------------------------------

SEEDS = [2_147_483_700, 3_000_000_001, 4_100_000_003]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", NEW_CELLS)
def test_control_is_not_correct(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a CUDA device")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", "5", "--trace", "0"],
                         bench_json=os.path.join(ROOT, "BENCHMARK.json"), control=True)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"control {cell} seed {seed}: {json.dumps(line['checks'])}")
    assert line["correct"] is False
