"""The readers of the program's own spans and counters (the aligner's
photoicp.GN, the loop closer's loop_closure.LC, the "planes join (thread)"
and "LC dense refinement" spans) on a fake context: each reads its number,
and None, never 0, where its counter or span is absent; and a traced run of
each tiny cell prints the ones its cell lists."""

import os
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tiny  # noqa: E402
from bench360.lib.harness import Bench  # noqa: E402

BENCH = Bench(os.path.join(tiny.ROOT, "BENCHMARK.json"))
GN_READERS = ("photoicp.issue_ms_per_iter", "photoicp.wait_ms_per_iter", "photoicp.syncs_per_iter")
NEW = GN_READERS + ("frame.planes_wait_ms", "slam.lc_refine_ms", "slam.lc_pairs_per_refinement")


def _ctx(units=0, stages=None):
    return SimpleNamespace(units=units, stages=stages or {}, counters={}, device_trace=None)


def read(name, ctx):
    return BENCH.metric(name).read(ctx)


def test_aligner_readers_read_photoicp_gn(monkeypatch):
    from rgbd360_torch.ops import photoicp

    monkeypatch.setattr(photoicp, "GN", {"iterations": 40, "syncs": 164, "wait_ns": 80_000_000,
                                         "host_ns": 600_000_000})
    assert read("photoicp.issue_ms_per_iter", _ctx()) == pytest.approx(13.0)
    assert read("photoicp.wait_ms_per_iter", _ctx()) == pytest.approx(2.0)
    assert read("photoicp.syncs_per_iter", _ctx()) == pytest.approx(4.1)


@pytest.mark.parametrize("gn", [None, {"iterations": 0, "syncs": 0, "wait_ns": 0, "host_ns": 0}])
def test_aligner_readers_read_none_without_iterations(monkeypatch, gn):
    from rgbd360_torch.ops import photoicp

    if gn is None:
        monkeypatch.delattr(photoicp, "GN")  # a program without the group
    else:
        monkeypatch.setattr(photoicp, "GN", gn)
    for name in GN_READERS:
        assert read(name, _ctx()) is None, name


def test_span_readers_read_their_span_per_frame():
    ctx = _ctx(units=40, stages={"planes join (thread)": 400.0, "LC dense refinement": 4000.0,
                                 "planes host fit": 1e6, "Loop closure": 1e6})
    assert read("frame.planes_wait_ms", ctx) == pytest.approx(10.0)
    assert read("slam.lc_refine_ms", ctx) == pytest.approx(100.0)
    empty = _ctx(units=40, stages={"a renamed stage": 5.0})
    assert read("frame.planes_wait_ms", empty) is None and read("slam.lc_refine_ms", empty) is None


def test_pairs_per_refinement_reads_loop_closure_lc(monkeypatch):
    from rgbd360_torch.core import loop_closure

    monkeypatch.setattr(loop_closure, "LC", dict(loop_closure.LC, refinements=12, refined_pairs=35))
    assert read("slam.lc_pairs_per_refinement", _ctx()) == pytest.approx(35 / 12)
    monkeypatch.setattr(loop_closure, "LC", dict(loop_closure.LC, refinements=0, refined_pairs=0))
    assert read("slam.lc_pairs_per_refinement", _ctx()) is None
    monkeypatch.delattr(loop_closure, "LC")
    assert read("slam.lc_pairs_per_refinement", _ctx()) is None


def test_each_new_metric_lists_the_cells_it_reads_in():
    spec = {m["name"]: m for m in BENCH.spec["per_layer"]}
    pairs, slam = ["pair360.track-b8", "pair360.lc-b8"], ["slam360.loop40", "slam360.arc20"]
    for name in NEW:
        assert spec[name]["workloads"] == (pairs if name in GN_READERS else slam), name


@pytest.mark.parametrize("cell, seconds, found", [
    ("pair360.tiny", 10, GN_READERS),
    # three frames close no loop: the loop closer refines nothing
    ("slam360.tiny", 17, ("frame.planes_wait_ms",)),
])
def test_a_traced_tiny_run_prints_them(tmp_path, cell, seconds, found):
    rc, line = tiny.run_cell(str(tmp_path), cell, seconds=seconds, trace=1)
    assert rc == 0 and line["correct"] is True
    for name in found:
        assert line["metrics"][name]["value"] > 0, name
