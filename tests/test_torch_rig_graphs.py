"""The CPU side of the robot-frame level loop's CUDA graphs
(ops/photoicp_pinhole.py, _LevelGraphs): made with no stream, a key's
segments (first sweep, loop body, retry round) run op by op on the CPU from
the same buffers and reads as the captured graphs, and equal the op-by-op
loop bit for bit, with and without retry rounds, in the three methods, and
count what it counts (SWEEPS, GN); the CPU runs every body op by op and
counts it so; the benchmark's reader of the graph share. The card's side
(captured graphs bit-equal to the op-by-op loop) is tests/test_torch_rig_batch.py's
test_on_the_card_the_graph_path_equals_the_eager_path.

The inputs are test_torch_rig_batch.py's: 8 sensors of 48 x 64 in the
benchmark's room, seeded motions.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import test_torch_rig_batch as rig_batch  # noqa: E402
from bench360.lib.harness import Bench  # noqa: E402
from rgbd360_torch.ops import photoicp  # noqa: E402
from rgbd360_torch.ops import photoicp_pinhole as pp  # noqa: E402
from rgbd360_torch.parallel.batch import align_batch_rig  # noqa: E402
from rgbd360_torch.utils import timing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTS = torch.from_numpy(rig_batch.RTS.astype(np.float32))
K = torch.from_numpy(rig_batch.K)
METHODS = {"photo_depth": pp.PHOTO_DEPTH, "photo": pp.PHOTO_CONSISTENCY, "depth": pp.DEPTH_CONSISTENCY}


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _same(got, want, what):
    assert len(got) == len(want), what
    for k, (a, b) in enumerate(zip(got, want)):
        if isinstance(a, tuple):
            _same(a, b, f"{what}[{k}]")
        else:
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), f"{what}[{k}]"


@pytest.fixture(scope="module")
def levels():
    """{name: the 3 levels of a batch}: "A" three seeded pairs, "B" three
    others, for a key's buffers to see other inputs."""
    out = {}
    for name, seeds in (("A", (1, 4, 7)), ("B", (3, 6, 8))):
        pairs = [rig_batch._pair(s) for s in seeds]
        imgs = [torch.stack([p[j] for p in pairs]) for j in range(4)]
        src = photoicp.build_pyramid_set(imgs[0], imgs[1], 3, is_target=False, sphere_seam_mask=False)
        trg = photoicp.build_pyramid_set(imgs[2], imgs[3], 3, is_target=True, sphere_seam_mask=False)
        out[name] = [photoicp.make_level_data(src, trg, lvl) for lvl in range(3)]
    return out


def _uncaptured_route(monkeypatch):
    """Send the level loop through _LevelGraphs made with no stream, one
    per key as the thread cache keeps them: the graph route's buffers,
    segments and reads, op by op."""
    keys = {}

    def level_graphs(device, bsz, spec, level, k_full, cam_rts):
        if (device, bsz, spec) not in keys:
            keys[device, bsz, spec] = pp._LevelGraphs(spec, level, k_full, cam_rts)
        return keys[device, bsz, spec]

    monkeypatch.setattr(photoicp, "_use_cuda_graphs", lambda device: True)
    monkeypatch.setattr(pp, "_level_graphs", level_graphs)
    return keys


def _counts():
    gn = dict(pp.GN)
    del gn["host_ns"], gn["wait_ns"]
    return gn, dict(pp.SWEEPS)


@pytest.mark.parametrize("method", METHODS.values(), ids=METHODS.keys())
@pytest.mark.parametrize("case, lvl, max_iters", [("retries", 1, 10), ("no_retry", 1, 2), ("no_body", 2, 0)])
def test_the_segments_equal_the_op_by_op_loop(levels, monkeypatch, method, case, lvl, max_iters):
    """One level of inputs A, B, A through one key's segments: each run's
    pose, state, iterations and ill-posed flag equal the op-by-op loop's
    bit for bit, and so do its SWEEPS and GN counts; a run's result is a
    copy that the next run leaves alone."""

    def run(name):
        pp.reset_sweep_counts()
        out = pp._align_level(levels[name][lvl], K, lvl, torch.eye(4).expand(3, 4, 4), method,
                              max_iters=max_iters, tol_update=1e-6, tol_residual=1e-1, lm_lambda0=1e-3,
                              lm_step=10.0, cam_rts=RTS)
        return out, _counts(), dict(pp.GRAPHS)

    eager = {name: run(name) for name in "AB"}
    for name, (_out, (gn, sweeps), graphs) in eager.items():
        assert graphs == {"captures": 0, "replays": 0, "eager_bodies": gn["iterations"]}
        assert sweeps["sweeps"] == 1 + gn["iterations"] + sweeps["lm_retries"]
        if case == "retries":
            assert sweeps["lm_retries"] > 0 and gn["pair_retries"] >= sweeps["lm_retries"]
        else:
            assert sweeps["lm_retries"] == 0 and gn["iterations"] == max_iters
    keys = _uncaptured_route(monkeypatch)
    got = [(name, run(name)) for name in "ABA"]
    assert len(keys) == 1
    for k, (name, (out, counts, graphs)) in enumerate(got):
        want, want_counts, _graphs = eager[name]
        _same(out, want, f"run {k} ({name})")
        assert counts == want_counts, (k, name)
        assert graphs == {"captures": 0, "eager_bodies": 0,
                          "replays": 1 + counts[0]["iterations"] + counts[1]["lm_retries"]}
    _same(got[0][1][0], eager["A"][0], "the first run's result after the others")


def test_a_whole_align_through_the_segments_equals_the_op_by_op_one(monkeypatch):
    """align_batch_rig, 3 levels, through the segments: the op-by-op
    result, counts, reads and spans, twice on the same keys."""
    images = [torch.stack([p[j] for p in (rig_batch._pair(1), rig_batch._pair(4))]) for j in range(4)]

    def align():
        timing.reset_timing()
        timing.stage_timing(True)
        try:
            pp.reset_sweep_counts()
            res = align_batch_rig(*images, RTS, K, torch.eye(4).expand(2, 4, 4), n_levels=3)
            names = sorted(s.name for s in timing.span_records())
        finally:
            timing.stage_timing(False)
            timing.reset_timing()
        return res, _counts(), names

    want, want_counts, want_names = align()
    assert want_counts[1]["lm_retries"] > 0 and pp.GRAPHS["eager_bodies"] == want_counts[0]["iterations"]
    keys = _uncaptured_route(monkeypatch)
    for k in range(2):
        res, counts, names = align()
        _same(res, want, f"align {k}")
        assert counts == want_counts and names == want_names, k
        assert pp.GRAPHS["eager_bodies"] == 0
    assert len(keys) == 3


def test_the_cpu_runs_every_body_op_by_op_and_counts_it(monkeypatch):
    """On the CPU the loop never asks for graphs: every body is an eager
    one, a second run of the same shapes too; reset_sweep_counts() clears
    GRAPHS. The route is photoicp's predicate: a CUDA device's."""
    asked = []
    monkeypatch.setattr(pp, "_level_graphs", lambda *args: asked.append(args))
    images = [torch.stack([rig_batch._pair(1)[j]]) for j in range(4)]
    pp.reset_sweep_counts()
    assert pp.GRAPHS == {"captures": 0, "replays": 0, "eager_bodies": 0}
    first = align_batch_rig(*images, RTS, K, torch.eye(4)[None], n_levels=3)
    second = align_batch_rig(*images, RTS, K, torch.eye(4)[None], n_levels=3)
    _same(first, second, "second align")
    assert asked == [] and pp.GN["iterations"] > 0
    assert pp.GRAPHS == {"captures": 0, "replays": 0, "eager_bodies": pp.GN["iterations"]}
    pp.reset_sweep_counts()
    assert set(pp.GRAPHS.values()) == {0}
    assert photoicp._use_cuda_graphs(torch.device("cuda", 0)) and not photoicp._use_cuda_graphs(torch.device("cpu"))


def _reader():
    return Bench(os.path.join(ROOT, "BENCHMARK.json")).metric("pinhole.graph_share")


def test_graph_share_reads_the_replayed_share_of_the_rig_loop_bodies(monkeypatch):
    """The benchmark's reader: photoicp_pinhole.GN iterations less GRAPHS
    eager_bodies over the iterations, %; None with no iteration, or with
    no GRAPHS group (the parent program)."""
    reader = _reader()
    gn = {"iterations": 40, "syncs": 70, "wait_ns": 1, "host_ns": 2, "pair_retries": 50}
    monkeypatch.setattr(pp, "GN", gn)
    monkeypatch.setattr(pp, "GRAPHS", {"captures": 12, "replays": 75, "eager_bodies": 6})
    assert reader.read(None) == pytest.approx(85.0)
    monkeypatch.setattr(pp, "GRAPHS", {"captures": 0, "replays": 0, "eager_bodies": 40})
    assert reader.read(None) == 0.0
    monkeypatch.setattr(pp, "GN", dict(gn, iterations=0))
    assert reader.read(None) is None
    monkeypatch.setattr(pp, "GN", gn)
    monkeypatch.delattr(pp, "GRAPHS")
    assert reader.read(None) is None
    monkeypatch.delattr(pp, "GN")
    assert reader.read(None) is None


def test_graph_share_reads_a_cpu_align():
    pp.reset_sweep_counts()
    assert _reader().read(None) is None
    images = [torch.stack([rig_batch._pair(4)[j]]) for j in range(4)]
    align_batch_rig(*images, RTS, K, torch.eye(4)[None], n_levels=2)
    assert _reader().read(None) == 0.0
