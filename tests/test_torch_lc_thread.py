"""The SphereGraphSLAM app's loop closer on its own thread (--lc-thread:
rgbd360_torch/core/loop_closure.py start / notify_keyframe / stop, and the
app's final drain), on the CPU.

The sessions run over a 5-capture arc of tools/synthetic_rig.py (6 deg and
~8.4 cm a step) with the loop closer's trajectory gap cut from 6 m to
0.2 m, so that the arc closes three loops: keyframe 3 against 0 through the
facade, keyframe 4 against 1 and 0 in one batch. Both of the port's
sessions are held to the JAX package's synchronous app
(rgbd360_tpu/apps/sphere_graph_slam.py) run on the same arc at the same
gap: the same closures accepted, in the same order where the port is
synchronous, the same pose graph, the optimized keyframe poses within
2e-5 and the closures' edges within 5e-4 (measured: 2.5e-6 and 1.4e-4, the
latter keyframe 4's batched refinement, whose GN iterates the two
packages reduce in another order). The synchronous session is besides
pinned to what it gave before the thread was reworked, within 1e-6. The
threaded session runs with its thread held back by a hook, so that
keyframes wait in its queue and closures arrive before the partition and
after the last frame: it must search every keyframe, drop none, and end
with every accepted closure drained and in the last optimized graph. The
queue's own rules (a stop that drains, an exception kept for stop, a
keyframe not taken counted as dropped) are held on a loop closer with a
stand-in search, and the partitioner on a topology the thread's late
closures make.
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.apps import sphere_graph_slam as sgs  # noqa: E402
from rgbd360_torch.core import loop_closure  # noqa: E402
from rgbd360_torch.core.graph_optimizer import GraphOptimizer  # noqa: E402
from rgbd360_torch.core.map360 import Map360  # noqa: E402
from rgbd360_torch.utils import timing  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

GAP_M = 0.2
ACCEPTED = [(0, 3, False), (1, 4, True), (0, 4, True)]
# the port's synchronous session's optimized keyframe positions and its
# closures' edge translations, as the app gave them before the thread's
# rework (beside the comparison with the JAX app)
OPTIMIZED_T = np.array([[0.0, 0.0, 0.0],
                        [-3.9631955e-04, 8.1325144e-02, -2.8547815e-03],
                        [-2.0967917e-04, 1.6212162e-01, -1.3671123e-02],
                        [2.0852382e-04, 2.3869966e-01, -3.1610020e-02],
                        [-4.4972982e-04, 3.1458893e-01, -6.2524803e-02]])
EDGE_T = {(0, 3): [0.0015137474983930588, 0.24480533599853516, -0.018763791769742966],
          (1, 4): [0.0005548592889681458, 0.2327786684036255, -0.08742300420999527],
          (0, 4): [0.0012122717453166842, 0.3279629349708557, -0.06595870852470398]}
SLOW_S = 0.2
POSE_TOL, EDGE_TOL = 2e-5, 5e-4  # port against the JAX app


@pytest.fixture(scope="module")
def arc_dirs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lc_thread"))
    rts = rig.write_calib_root(os.path.join(d, "calib"))
    rig.write_sequence(os.path.join(d, "seq"), rts, frames=5, loops=5 * 6.0 / 360.0, radius=0.8)
    return [os.path.join(d, "seq"), "--calib-root", os.path.join(d, "calib")]


@pytest.fixture(scope="module")
def arc(arc_dirs):
    return arc_dirs + ["--device", "cpu"]


@pytest.fixture(scope="module")
def jax_sync(arc_dirs):
    """The JAX package's synchronous app on the arc at the same gap:
    (the closures its loop closer accepted in order, its map, its
    optimizer)."""
    from rgbd360_tpu.apps import sphere_graph_slam as j_sgs
    from rgbd360_tpu.core import loop_closure as j_lc

    made, accepted = [], []

    class Recorded(j_sgs.LoopClosure360):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def process_new_keyframe(self, kf_id):
            n = len(self.optimizer.edges)
            out = super().process_new_keyframe(kf_id)
            accepted.extend((e.i, e.j) for e in self.optimizer.edges[n:])
            return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_lc, "MIN_TRAJECTORY_GAP", GAP_M)
        mp.setattr(j_sgs, "LoopClosure360", Recorded)
        assert j_sgs.main(list(arc_dirs)) == 0
    (lc,) = made
    return accepted, lc.map, lc.optimizer


def _assert_map_is_the_jax_apps(session, jax_sync):
    """The port's session against the JAX app's: the same closures, the
    same graph, the optimized poses and the closures' edges close."""
    accepted, world, optimizer = jax_sync
    assert len(accepted) == 3 and sorted((c, k) for c, k, _b in session.loop_closer.accepted) == sorted(accepted)
    assert sorted((e.i, e.j) for e in session.optimizer.edges) == sorted((e.i, e.j) for e in optimizer.edges)
    ours, theirs = np.array(session.world.optimized_poses), np.array(world.optimized_poses)
    assert ours.shape == theirs.shape == (5, 4, 4)
    np.testing.assert_allclose(ours[:, :3, :], theirs[:, :3, :], rtol=0, atol=POSE_TOL)
    for cand, kf in accepted:
        np.testing.assert_allclose(session.world.connection_kfs[kf][cand][0][:3, :],
                                   np.asarray(world.connection_kfs[kf][cand][0])[:3, :], rtol=0, atol=EDGE_TOL)


def _thread_counts():
    return dict(timing.counters()["loop_closure.THREAD"])


def _session(argv):
    """One run() with the short gap; returns (session, THREAD counts it
    added, the edges of each graph optimization)."""
    graphs = []
    real = GraphOptimizer.optimize_graph

    def recorded(self, *a, **k):
        graphs.append([(e.i, e.j) for e in self.edges])
        return real(self, *a, **k)

    before = _thread_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_closure, "MIN_TRAJECTORY_GAP", GAP_M)
        mp.setattr(GraphOptimizer, "optimize_graph", recorded)
        session = sgs.run(argv)
    after = _thread_counts()
    return session, {k: after[k] - before[k] for k in after}, graphs


@pytest.fixture(scope="module")
def threaded(arc):
    """The --lc-thread session with its thread held back, traced: the
    search of keyframe 1 waits until keyframe 3 is queued (the app then
    waits for all three before its partition at 4 keyframes), that of
    keyframe 4 until the app stops the thread, and each takes SLOW_S
    longer. (session, THREAD counts, graphs' edges, spans)."""
    lc = loop_closure.LoopClosure360
    search, notify, stop = lc.process_new_keyframe, lc.notify_keyframe, lc.stop
    kf3_queued, stopping = threading.Event(), threading.Event()

    def notified(self, kf_id, frame=None):
        notify(self, kf_id, frame)
        if kf_id == 3:
            kf3_queued.set()

    def slowed(self, kf_id):
        if kf_id == 1:
            assert kf3_queued.wait(timeout=300)
        if kf_id == 4:
            assert stopping.wait(timeout=300)
        time.sleep(SLOW_S)
        return search(self, kf_id)

    def stopped(self):
        stopping.set()
        stop(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lc, "process_new_keyframe", slowed)
        mp.setattr(lc, "notify_keyframe", notified)
        mp.setattr(lc, "stop", stopped)
        mp.setattr(timing, "_trace_path", "unused")  # spans recorded, nothing written
        timing.reset_timing()
        session, counts, graphs = _session(arc + ["--lc-thread"])
        spans = timing.span_records()
    timing.reset_timing()
    return session, counts, graphs, spans


def test_synchronous_map_is_unchanged(arc, jax_sync):
    session, counts, graphs = _session(arc)
    lc = session.loop_closer
    _assert_map_is_the_jax_apps(session, jax_sync)
    assert [(c, k) for c, k, _b in lc.accepted] == jax_sync[0]
    assert lc.accepted == ACCEPTED and lc.refinements == [1, 2] and session.n_loop_closures == 3
    assert len(session.world) == 5 and len(session.world.areas) == 1
    np.testing.assert_allclose(np.array(session.world.optimized_poses)[:, :3, 3], OPTIMIZED_T, rtol=0, atol=1e-6)
    for (cand, kf), t in EDGE_T.items():
        np.testing.assert_allclose(session.world.connection_kfs[kf][cand][0][:3, 3], t, rtol=0, atol=1e-6)
    assert counts["notified"] == counts["taken"] == 0 and len(graphs) == 2


def test_a_slowed_thread_searches_every_keyframe(threaded, jax_sync):
    session, counts, _graphs, _spans = threaded
    keyframes = len(session.world)
    assert keyframes == 5
    assert counts["notified"] == counts["taken"] == keyframes - 1
    assert counts["dropped"] == 0
    # the hook held the thread back: keyframe 3 waited behind 2
    assert counts["queued_at_take"] == 1 and counts["busy_ns"] >= (keyframes - 1) * SLOW_S * 1e9
    assert sorted((c, k) for c, k, _b in session.loop_closer.accepted) == sorted(jax_sync[0])
    assert sorted(session.loop_closer.accepted) == sorted(ACCEPTED)


def test_a_slowed_thread_leaves_nothing_undrained(threaded, jax_sync):
    session, counts, graphs, _spans = threaded
    assert session.n_loop_closures == len(session.loop_closer.accepted) == 3
    assert not session.loop_closer.connections_lc and counts["drain_ns"] > 0
    # keyframe 3's closure drained before the partition, keyframe 4's two
    # after the last frame: each is an edge of the last optimization
    assert len(graphs) == 2 and (0, 3) in graphs[0] and (0, 4) not in graphs[0]
    last = set(graphs[-1])
    assert all((cand, kf) in last for cand, kf, _b in session.loop_closer.accepted)
    assert len(last) == len(session.optimizer.edges) == (len(session.world) - 1) + 3
    # the same closures and graph as the JAX app's synchronous session: the same optimum
    _assert_map_is_the_jax_apps(session, jax_sync)
    np.testing.assert_allclose(np.array(session.world.optimized_poses)[:, :3, 3], OPTIMIZED_T, rtol=0, atol=1e-5)
    for (cand, kf), t in EDGE_T.items():
        np.testing.assert_allclose(session.world.connection_kfs[kf][cand][0][:3, 3], t, rtol=0, atol=1e-6)


def test_the_thread_spans_name_their_frames(threaded):
    _session_, _counts, _graphs, spans = threaded
    taken = [s for s in spans if s.name == "loop closure (thread)"]
    assert sorted(s.attrs["frame"] for s in taken) == [2, 3, 4, 5]
    assert all(s.thread == "LoopClosure360" for s in taken)
    drains = [s for s in spans if s.name == "loop closure drain"]
    assert len(drains) == 1 and drains[0].end_ns >= max(s.end_ns for s in taken)
    # the wait before the partition at 4 keyframes, after keyframe 3's search
    (wait,) = [s for s in spans if s.name == "loop closure wait"]
    assert wait.attrs["frame"] == 4 and wait.end_ns >= [s.end_ns for s in taken if s.attrs["frame"] == 4][0]


def _stand_in(searched, fail_on=(), delay_s=0.0):
    """A loop closer on an empty map whose search records the keyframe (and
    raises on ``fail_on``)."""
    lc = loop_closure.LoopClosure360(Map360(), device="cpu")

    def search(kf_id):
        time.sleep(delay_s)
        if kf_id in fail_on:
            raise RuntimeError(f"search of kf {kf_id} failed")
        searched.append(kf_id)
        return 0

    lc.process_new_keyframe = search
    return lc


def test_stop_searches_every_queued_keyframe():
    searched = []
    lc = _stand_in(searched, delay_s=0.02)
    before = _thread_counts()
    lc.start()
    for kf in range(1, 11):
        lc.notify_keyframe(kf)
    lc.stop()
    counts = {k: v - before[k] for k, v in _thread_counts().items()}
    assert searched == list(range(1, 11))
    assert counts["taken"] == 10 and counts["dropped"] == 0 and counts["queued_at_take"] > 0


def test_an_exception_in_the_thread_surfaces_at_stop():
    searched = []
    lc = _stand_in(searched, fail_on=(2,))
    lc.start()
    for kf in (1, 2, 3):
        lc.notify_keyframe(kf)
    with pytest.raises(RuntimeError, match="kf 2"):
        lc.stop()
    assert searched == [1, 3]  # the thread lived on past the failure
    lc.stop()  # raised once


def test_a_keyframe_no_thread_searches_counts_as_dropped(monkeypatch):
    """A keyframe is queued only for a started thread; one the thread
    never took (here its take skipped) counts as dropped at stop."""
    searched = []
    lc = _stand_in(searched)
    with pytest.raises(RuntimeError, match="before start"):
        lc.notify_keyframe(1)
    take = loop_closure.LoopClosure360._take
    monkeypatch.setattr(loop_closure.LoopClosure360, "_take",
                        lambda self, item: None if item[0] == 2 else take(self, item))
    before = _thread_counts()
    lc.start()
    for kf in (1, 2, 3):
        lc.notify_keyframe(kf)
    lc.stop()
    counts = {k: v - before[k] for k, v in _thread_counts().items()}
    assert searched == [1, 3] and counts["taken"] == 2 and counts["dropped"] == 1


def test_the_partitioner_rehomes_rows_into_fresh_blocks(monkeypatch):
    """A topology the thread's late closures make: areas 1 and 2 neighbour
    the current area 0, and both neighbour area 3, outside the vicinity.
    The split (fixed here) moves keyframes 4 and 5 from area 1 to area 2,
    which shrinks from 5 keyframes to 3. Keyframe 4's row of block (1, 3)
    must land in a fresh block (2, 3), not in the stale 5-row one still to
    be re-homed (which raised), and each row keeps its keyframe."""
    from types import SimpleNamespace

    from rgbd360_torch.core import topological

    m = Map360()
    members = [[0, 1, 2], [3, 4, 5], [6, 7, 8, 9, 10], [11, 12, 13]]
    for area, kfs in enumerate(members):
        for kf in kfs:
            m.frames.append(SimpleNamespace(id=kf, node=area))
    m.areas = [set(kfs) for kfs in members]
    m.neighbor_areas = [{0, 1, 2}, {0, 1, 3}, {0, 2, 3}, {1, 2, 3}]
    m.selected_kfs = [0, 3, 6, 11]
    m.current_area = 0
    topo = topological.TopologicalMap360(m)
    topo.v_sso = [np.full((len(kfs), len(kfs)), 0.9, np.float32) for kfs in members]
    topo.neig_sso = {(0, 1): np.full((3, 3), 0.1, np.float32), (0, 2): np.full((3, 5), 0.1, np.float32),
                     (1, 3): np.zeros((3, 3), np.float32), (2, 3): np.zeros((5, 3), np.float32)}
    topo.neig_sso[(1, 3)][1] = [0.5, 0.6, 0.7]  # keyframe 4
    topo.neig_sso[(2, 3)][0] = [0.2, 0.3, 0.4]  # keyframe 6
    topo.neig_sso[(2, 3)][3] = [0.8, 0.0, 0.1]  # keyframe 9
    # local indices over the vicinity's keyframes 0-10
    monkeypatch.setattr(topological, "recursive_spectral_partition",
                        lambda sso, *a, **k: [[0, 1, 2], [3], [4, 5, 6], [7, 8, 9, 10]])
    assert topo.partitioner()
    assert [sorted(a) for a in m.areas] == [[0, 1, 2], [3], [4, 5, 6], [11, 12, 13], [7, 8, 9, 10]]
    np.testing.assert_array_equal(topo.neig_sso[(2, 3)], np.float32([[0.5, 0.6, 0.7], [0, 0, 0], [0.2, 0.3, 0.4]]))
    # keyframe 9, third of area 4, re-homed into the block (3, 4) as a column
    np.testing.assert_array_equal(topo.neig_sso[(3, 4)][:, 2], np.float32([0.8, 0.0, 0.1]))
    assert 3 in m.neighbor_areas[2] and 3 in m.neighbor_areas[4] and 1 not in m.neighbor_areas[3]
