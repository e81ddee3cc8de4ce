"""The port's pair mesh (rgbd360_torch/parallel/mesh.py), the split route
of the loop closer's batched refinement, the dry run
(rgbd360_torch/parallel/dryrun.py) and the thread safety of the launch and
sweep counters, on the CPU.

A split is held bit-equal to the unsplit call (every AlignResult field,
iteration counts included): each pair is reduced on its own
(ops/photoicp.py::_pair_grams), so the pairs of a batch are independent.
Against JAX's align_batch_sharded on a 2-device mesh of the virtual CPU
devices tests/conftest.py provides: poses within 1e-4
(tests/test_torch_photoicp.py's batched-loop tolerance), the iteration
counts equal, and the finest errors within 1e-3 (the port's align-parity
test holds each package's error within 0.15 of the golden free run; here
the f32 sums' order moves a near-converged error by up to 6e-5).
"""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.core import loop_closure as lc_mod  # noqa: E402
from rgbd360_torch.core.batch_match import prefilter_candidates  # noqa: E402
from rgbd360_torch.core.matcher import PLANAR_3DOF, PLANAR_ODOMETRY_3DOF, MatcherConfig  # noqa: E402
from rgbd360_torch.core.pbmap import PbMap, Plane  # noqa: E402
from rgbd360_torch.ops import photoicp as tp  # noqa: E402
from rgbd360_torch.ops import warp_gather as tw  # noqa: E402
from rgbd360_torch.parallel import dryrun  # noqa: E402
from rgbd360_torch.parallel import mesh as pmesh  # noqa: E402
from rgbd360_torch.parallel.batch import align_batch  # noqa: E402
from rgbd360_torch.utils import timing  # noqa: E402
from rgbd360_tpu.core import batch_match as j_batch_match  # noqa: E402
from rgbd360_tpu.core import pbmap as j_pbmap  # noqa: E402
from rgbd360_tpu.parallel import mesh as jmesh  # noqa: E402

CPU = torch.device("cpu")


def _pairs(h, w, batch):
    """The dry run's synthetic panorama as source and target, each pair
    from its own yawed seed."""
    gray, depth = dryrun.synthetic_pair(h, w, batch)
    return gray, depth, gray, depth, dryrun.yawed_seeds(batch)


@pytest.fixture
def windowed_route(monkeypatch):
    """The windowed route on the CPU: levels of >= 9,000 pixels take the
    warp gather's plain versions."""
    monkeypatch.setattr(tp, "_use_warp_kernel", lambda shape, device: shape[0] * shape[1] >= 9_000)


@pytest.mark.parametrize("n_devices,batch,shape", [(2, 8, (96, 576)), (4, 8, (96, 576)), (4, 4, (160, 960))],
                         ids=["2x4", "4x2", "4x1"])
@pytest.mark.parametrize("route", ["exact", "windowed"])
def test_align_batch_sharded_is_bit_equal_to_align_batch(request, n_devices, batch, shape, route):
    """Shards of 4, 2 and 1 pairs. Before the per-pair reductions
    (photoicp._pair_grams) a one-pair shard at 160 x 960 took torch's
    two-pass reduction for its error sums and came out of the split with
    other errors than in the batch."""
    if route == "windowed":
        request.getfixturevalue("windowed_route")
    args = _pairs(*shape, batch)
    tp.reset_sweep_counts()
    split = pmesh.align_batch_sharded([CPU] * n_devices, *args, n_levels=3 if shape[0] == 96 else 2)
    assert tp.SWEEPS["windowed" if route == "windowed" else "exact"] > 0
    whole = align_batch(*args, n_levels=3 if shape[0] == 96 else 2)
    dryrun.assert_same_result(split, whole, f"{n_devices} shards")
    assert whole.num_iterations.sum() > batch  # the pairs iterate, each its own way
    assert len({tuple(r) for r in whole.num_iterations.tolist()}) > 1


def test_full_coverage_split_is_bit_equal(windowed_route):
    args = _pairs(96, 576, 6)
    split = pmesh.align_batch_sharded([CPU] * 3, *args, n_levels=2, full_coverage=True)
    dryrun.assert_same_result(split, align_batch(*args, n_levels=2, full_coverage=True), "full coverage")


def test_align_batch_sharded_matches_jax_on_a_two_device_mesh():
    gray, depth, _g, _d, seeds = _pairs(32, 192, 8)
    m = jmesh.make_mesh(jax.devices("cpu")[:2])
    args_j = jmesh.shard_pairs(m, *(jnp.asarray(x.numpy()) for x in (gray, depth, gray, depth, seeds)))
    res_j = jmesh.align_batch_sharded(m, *args_j, n_levels=3)
    res_t = pmesh.align_batch_sharded([CPU, CPU], gray, depth, gray, depth, seeds, n_levels=3)
    np.testing.assert_allclose(res_t.pose.numpy(), np.asarray(res_j.pose), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res_t.error.numpy(), np.asarray(res_j.error), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(res_t.num_iterations.numpy(), np.asarray(res_j.num_iterations))
    assert res_t.num_iterations.sum() > 0


def test_shard_and_split_pairs():
    x = torch.arange(12).reshape(6, 2)
    shards = pmesh.shard_pairs([CPU] * 3, x)[0]
    assert [s.tolist() for s in shards] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]], [[8, 9], [10, 11]]]
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_pairs([CPU] * 4, x)
    assert [len(s) for s in pmesh.split_pairs([CPU] * 4, x)[0]] == [2, 2, 1, 1]
    assert pmesh.make_mesh(["cpu", CPU]) == [CPU, CPU]
    assert pmesh.pair_devices(CPU) == [CPU]
    with pytest.raises(ValueError):
        pmesh.make_mesh([])


def test_a_shard_failure_is_raised(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("shard failed")

    monkeypatch.setattr(pmesh, "align_batch", boom)
    with pytest.raises(RuntimeError, match="shard failed"):
        pmesh.align_batch_sharded([CPU, CPU], *_pairs(32, 192, 2), n_levels=2)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.pair_devices("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)


def _pbmap(planes, package):
    mod = j_pbmap if package == "jax" else None
    pb = (mod.PbMap if mod else PbMap)()
    pb.planes = [(mod.Plane if mod else Plane)(**p) for p in planes]
    return pb


def _random_planes(rng, n):
    planes = []
    for k in range(n):
        normal = rng.normal(size=3).astype(np.float32)
        normal /= np.linalg.norm(normal)
        if k % 3 == 0:
            normal = np.array([1.0, 0.0, 0.0], np.float32)  # up-facing: passes the planar gate
        d = float(rng.uniform(0.5, 3.0))
        planes.append(dict(id=k, normal=normal, center=-d * normal, d=-d,
                           area_hull=float(rng.uniform(0.5, 6.0)), elongation=float(rng.uniform(1.0, 4.0))))
    return planes


@pytest.mark.parametrize("n_devices", [2, 3])
@pytest.mark.parametrize("mode", [PLANAR_3DOF, PLANAR_ODOMETRY_3DOF])
def test_prefilter_candidates_sharded_equals_the_unsplit_sweeps(n_devices, mode):
    rng = np.random.default_rng(11)
    query = _random_planes(rng, 6)
    cands = [_random_planes(rng, int(rng.integers(2, 9))) for _ in range(7)]
    config = MatcherConfig()
    counts, areas = pmesh.prefilter_candidates_sharded(
        [CPU] * n_devices, _pbmap(query, "port"), [_pbmap(c, "port") for c in cands], config, mode)
    counts_t, areas_t = prefilter_candidates(_pbmap(query, "port"), [_pbmap(c, "port") for c in cands], config, mode,
                                             device="cpu")
    counts_j, areas_j = j_batch_match.prefilter_candidates(
        _pbmap(query, "jax"), [_pbmap(c, "jax") for c in cands], config, mode)
    np.testing.assert_array_equal(counts, counts_t)
    np.testing.assert_array_equal(areas, areas_t)
    np.testing.assert_array_equal(counts, np.asarray(counts_j))
    np.testing.assert_allclose(areas, np.asarray(areas_j), rtol=1e-6)
    assert counts.shape == (7,) and counts.max() > 0
    assert pmesh.prefilter_candidates_sharded([CPU] * 2, _pbmap(query, "port"), [], config, mode)[0].shape == (0,)


def test_refine_batch_takes_the_split_route_with_equal_results(monkeypatch):
    """_refine_batch splits its survivors over the devices beside the loop
    closer's (pmesh.pair_devices, made to report two here): 3 survivors
    become contiguous shards of 2 and 1, and the accept-gate quantities
    equal the unsplit route's."""
    h, w = 32, 192
    rng = np.random.default_rng(9)
    g = rng.uniform(0.2, 0.8, size=(h, w)).astype(np.float32)
    d_mm = rng.uniform(1500, 3500, size=(h, w)).astype(np.float32)

    def frame(roll):
        return types.SimpleNamespace(sphere_gray=torch.from_numpy(np.roll(g, roll, axis=1)),
                                     sphere_depth_mm=torch.from_numpy(np.roll(d_mm, roll, axis=1)).to(torch.int32))

    lc = lc_mod.LoopClosure360.__new__(lc_mod.LoopClosure360)
    lc.map = types.SimpleNamespace(frames={0: frame(1), 1: frame(2), 2: frame(-1)})
    lc.aligner = types.SimpleNamespace(n_pyr_levels=2)
    lc.device = CPU
    survivors = [(0, np.eye(4)), (1, np.eye(4)), (2, np.eye(4))]
    unsplit = lc._refine_batch(frame(0), survivors)

    meshes = []
    real_shards = pmesh.align_shards

    def spy(mesh, *shards, **kwargs):
        meshes.append((list(mesh), [len(s) for s in shards[0]]))
        return real_shards(mesh, *shards, **kwargs)

    monkeypatch.setattr(pmesh, "pair_devices", lambda device: [CPU, CPU])
    monkeypatch.setattr(pmesh, "align_shards", spy)
    split = lc._refine_batch(frame(0), survivors)
    assert meshes == [([CPU, CPU], [2, 1])]
    assert len(split) == len(unsplit) == 3
    for (c1, p1, a1, h1, s1), (c2, p2, a2, h2, s2) in zip(split, unsplit):
        assert c1 == c2 and a1 == a2 and s1 == s2
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(h1, h2)
    assert any(np.abs(p - np.eye(4)).max() > 1e-4 for _c, p, *_ in split)  # a real motion was recovered


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multichip_on_the_cpu(n_devices, capsys):
    report = dryrun.dryrun_multichip(n_devices, device="cpu")
    assert f"dryrun_multichip OK: {n_devices} shards of cpu" in capsys.readouterr().out
    assert report["kernel"]["sweeps"]["windowed"] > 0 and report["kernel"]["sweeps"]["exact_final_dual"] == n_devices
    assert len(report["tracking"]["iterations"]) == dryrun.PAIRS_PER_DEVICE * n_devices
    assert report["prefilter"]["counts"] == [3] * (n_devices + 3)
    # the CPU runs the plain versions: no kernel launched
    assert all(v == 0 for leg in ("tracking", "lc", "kernel") for v in report[leg]["launches"].values())


def test_sweep_counts_are_exact_across_threads(windowed_route):
    """Sixteen threads through the windowed sweeps of the plain path at
    once: every sweep counted."""
    args = _pairs(96, 576, 1)
    tp.reset_sweep_counts()
    align_batch(*args, n_levels=2)
    one = dict(tp.SWEEPS)
    tp.reset_sweep_counts()
    threads = [threading.Thread(target=align_batch, args=args, kwargs=dict(n_levels=2)) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert one["windowed"] > 0
    assert tp.SWEEPS == {k: 16 * v for k, v in one.items()}


def test_every_count_is_taken_under_the_lock(monkeypatch, windowed_route):
    """Each increment of SWEEPS (and, on the card, LAUNCHES) holds
    timing.COUNT_LOCK: a bare ``+=`` from the shard threads could lose an
    update, and chip_smoke.py holds launches equal to sweeps."""
    held = []

    class RecordingLock:
        def __init__(self):
            self.lock = threading.Lock()
            self.depth = 0

        def __enter__(self):
            self.lock.acquire()
            self.depth += 1

        def __exit__(self, *exc):
            self.depth -= 1
            self.lock.release()

    lock = RecordingLock()
    monkeypatch.setattr(timing, "COUNT_LOCK", lock)

    class Counts(dict):
        def __setitem__(self, key, value):
            held.append(lock.depth == 1)
            super().__setitem__(key, value)

    monkeypatch.setattr(tp, "SWEEPS", Counts(tp.SWEEPS))
    monkeypatch.setattr(tw, "LAUNCHES", Counts(tw.LAUNCHES))
    align_batch(*_pairs(96, 576, 2), n_levels=2)
    timing.count(tw.LAUNCHES, "warp_gather_batched")
    assert len(held) > 3 and all(held)
