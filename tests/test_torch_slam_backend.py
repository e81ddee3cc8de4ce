"""The SLAM back end of the port (rgbd360_torch/core/{graph_optimizer,
topological,map360,batch_match}.py, the SLAM-state converters of
rgbd360_torch/convert.py) against the JAX package, on the CPU.

graph_optimizer, topological and map360 are numpy copies: the scenarios of
tests/test_slam_backend.py (the circle loop, the robust kernel against a
false loop closure, SE(2) graphs, the partitioner's splits) are built in
JAX, carried into the port with convert.py and run in both; poses,
chi2 and partitions are held equal to 1e-9.

batch_match's compatibility matrices are a torch broadcast on the device in
the port and a vmapped jit in JAX. Held equal (bool) on seeded random plane
sets, and on pairs placed 1e-3 (relative) from each threshold on either
side. The Bhattacharyya coefficient and the normals' cosine are f32 sums in
torch's order, not XLA's: a pair within 1e-6 of its threshold could fall on
the other side, and ``_near`` names such pairs; the random sets hold none,
so every entry is compared.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd360_torch import convert  # noqa: E402
from rgbd360_torch.core import batch_match as t_bm  # noqa: E402
from rgbd360_torch.core import graph_optimizer as t_go  # noqa: E402
from rgbd360_torch.core import map360 as t_map  # noqa: E402
from rgbd360_torch.core import matcher as t_matcher  # noqa: E402
from rgbd360_torch.core import topological as t_topo  # noqa: E402
from rgbd360_torch.core.pbmap import HIST_H_BINS  # noqa: E402
from rgbd360_tpu.core import batch_match as j_bm  # noqa: E402
from rgbd360_tpu.core import graph_optimizer as j_go  # noqa: E402
from rgbd360_tpu.core import map360 as j_map  # noqa: E402
from rgbd360_tpu.core import topological as j_topo  # noqa: E402

MODES = [t_matcher.DEFAULT_6DOF, t_matcher.PLANAR_3DOF, t_matcher.ODOMETRY_6DOF, t_matcher.PLANAR_ODOMETRY_3DOF]


class FakeFrame:
    def __init__(self):
        self.id = 0
        self.node = 0
        self.pose = np.eye(4, dtype=np.float32)


# -- pose graph -------------------------------------------------------------------


def _circle(rng, n=12, radius=3.0, drift=0.02):
    """tests/test_slam_backend.py::_circle_graph: ground truth on a circle in
    vertex 0's frame, drifting odometry."""
    gt = []
    for k in range(n):
        th = 2 * np.pi * k / n
        T = np.eye(4)
        c, s = np.cos(th), np.sin(th)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = [radius * c, radius * s, 0]
        gt.append(T)
    gt = [np.linalg.inv(gt[0]) @ T for T in gt]
    odo = [np.linalg.inv(gt[k]) @ gt[k + 1] @ j_go._exp_se3(drift * rng.normal(size=6)) for k in range(n - 1)]
    return gt, odo


def _graph_circle(rng):
    gt, odo = _circle(rng)
    opt = j_go.GraphOptimizer()
    pose = np.eye(4)
    opt.add_vertex(pose)
    for z in odo:
        pose = pose @ z
        opt.add_vertex(pose)
    for k, z in enumerate(odo):
        opt.add_edge(k, k + 1, z, np.eye(6))
    opt.add_edge(len(gt) - 1, 0, np.linalg.inv(gt[-1]) @ gt[0], 10 * np.eye(6))
    return opt, 20


def _graph_false_lc(rng, robust):
    """test_robust_kernel_rejects_false_loop_closure's graph with the false
    loop closure."""
    gt, odo = _circle(rng)
    n = len(gt)
    opt = j_go.GraphOptimizer(robust=robust)
    pose = np.eye(4)
    opt.add_vertex(pose)
    for z in odo:
        pose = pose @ z
        opt.add_vertex(pose)
    for k, z in enumerate(odo):
        opt.add_edge(k, k + 1, z, 100 * np.eye(6))
    opt.add_edge(n - 1, 0, np.linalg.inv(gt[-1]) @ gt[0], 10 * np.eye(6))
    bad = np.linalg.inv(gt[0]) @ gt[n // 2]
    bad[:3, 3] += np.array([1.5, -0.8, 0.4])
    opt.add_edge(0, n // 2, bad, 10 * np.eye(6))
    return opt, 25


def _graph_se2(rng, axis):
    """test_se2_circle_graph_closes (axis z) and the planar_axis='x' case."""
    opt = j_go.GraphOptimizer(rigidity=3, planar_axis=axis)
    n = 12
    truth = [opt._v2t((np.cos(k * 2 * np.pi / n), np.sin(k * 2 * np.pi / n), k * 2 * np.pi / n + np.pi / 2))
             for k in range(n)]
    poses = [truth[0]]
    for k in range(1, n):
        noisy = np.linalg.inv(truth[k - 1]) @ truth[k]
        noisy[:3, 3] += rng.normal(scale=0.03, size=3) * (np.arange(3) != (2 if axis == "z" else 0))
        poses.append(poses[-1] @ noisy)
    for p in poses:
        opt.add_vertex(p)
    for k in range(1, n):
        opt.add_edge(k - 1, k, np.linalg.inv(truth[k - 1]) @ truth[k], np.eye(6) * 100.0)
    opt.add_edge(n - 1, 0, np.linalg.inv(truth[n - 1]) @ truth[0], np.eye(6) * 100.0)
    return opt, 30


GRAPHS = {
    "circle": _graph_circle,
    "false_lc_plain": lambda rng: _graph_false_lc(rng, False),
    "false_lc_robust": lambda rng: _graph_false_lc(rng, True),
    "se2_z": lambda rng: _graph_se2(rng, "z"),
    "se2_x": lambda rng: _graph_se2(rng, "x"),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pose_graph_scenarios_equal_jax(name):
    j_opt, iters = GRAPHS[name](np.random.default_rng(0))
    t_opt = convert.optimizer_from_numpy(j_opt)
    assert isinstance(t_opt, t_go.GraphOptimizer) and len(t_opt.edges) == len(j_opt.edges)
    chi2_t, chi2_j = t_opt.optimize_graph(iterations=iters), j_opt.optimize_graph(iterations=iters)
    assert chi2_t == pytest.approx(chi2_j, rel=1e-9, abs=1e-12)
    for a, b in zip(t_opt.get_poses(), j_opt.get_poses()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert np.abs(np.asarray(t_opt.get_poses()) - np.asarray(t_opt.vertices)).max() == 0


def test_robust_kernel_keeps_the_false_loop_closure_out():
    """The robust port optimizer recovers the outlier-free solution where the
    plain one is dragged (tests/test_slam_backend.py:360, measured clean
    0.252, plain 1.344, robust 0.240 m there)."""
    gt, _odo = _circle(np.random.default_rng(0))
    errs = {}
    for robust in (False, True):
        opt = convert.optimizer_from_numpy(_graph_false_lc(np.random.default_rng(0), robust)[0])
        opt.optimize_graph(iterations=25)
        errs[robust] = max(np.linalg.norm(p[:3, 3] - g[:3, 3]) for p, g in zip(opt.get_poses(), gt))
    assert errs[False] > 3 * errs[True], errs


def test_graph_files_equal_jax(tmp_path):
    j_opt, _ = _graph_circle(np.random.default_rng(1))
    for opt, name in ((j_opt, "jax.g2o"), (convert.optimizer_from_numpy(j_opt), "port.g2o")):
        opt.save_graph(str(tmp_path / name))
    assert (tmp_path / "port.g2o").read_text() == (tmp_path / "jax.g2o").read_text()
    j_se2, _ = _graph_se2(np.random.default_rng(1), "x")
    j_se2.save_graph(str(tmp_path / "jax2.g2o"))
    convert.optimizer_from_numpy(j_se2).save_graph(str(tmp_path / "port2.g2o"))
    assert (tmp_path / "port2.g2o").read_text() == (tmp_path / "jax2.g2o").read_text()


# -- map and topology ----------------------------------------------------------------


def _chains(map_mod, topo_mod, groups, links, n_kf):
    """A map of n_kf keyframes 1 m apart whose SSO forms cliques (0.9) with
    weak links between them."""
    m = map_mod.Map360()
    topo = topo_mod.TopologicalMap360(m)
    for k in range(n_kf):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 1.0 * k
        m.add_keyframe(FakeFrame(), T)
        topo.add_keyframe(m.current_area)
    for grp in groups:
        for a in grp:
            for b in grp:
                if a < b:
                    topo.add_connection(a, b, 0.9)
    for a, b, v in links:
        topo.add_connection(a, b, v)
    return m, topo


TOPOLOGIES = {
    "two_chains": ([range(6), range(6, 12)], [(5, 6, 0.05)], 12),
    "three_cliques": ([range(6), range(6, 12), range(12, 18)], [(5, 6, 0.05), (11, 12, 0.05)], 18),
    "interleaved": ([range(0, 12, 2), range(1, 12, 2)], [(4, 9, 0.05), (6, 11, 0.07)], 12),
    "tight": ([range(8)], [], 8),
}


def _topo_state(m, topo):
    return (
        [f.node for f in m.frames], [sorted(a) for a in m.areas], [sorted(a) for a in m.neighbor_areas],
        list(m.selected_kfs), m.current_area,
        [np.asarray(v).tolist() for v in topo.v_sso],
        {k: np.asarray(b).tolist() for k, b in topo.neig_sso.items()},
    )


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_partitioner_scenarios_equal_jax(name):
    groups, links, n_kf = TOPOLOGIES[name]
    m_j, topo_j = _chains(j_map, j_topo, groups, links, n_kf)
    # the port's state carried across from JAX's, and built by the port itself
    m_c = convert.map_from_numpy(m_j, [FakeFrame() for _ in range(n_kf)])
    topo_c = convert.topo_from_numpy(topo_j, m_c)
    m_t, topo_t = _chains(t_map, t_topo, groups, links, n_kf)
    assert _topo_state(m_c, topo_c) == _topo_state(m_t, topo_t) == _topo_state(m_j, topo_j)
    changed = {topo_j.partitioner(), topo_c.partitioner(), topo_t.partitioner()}
    assert changed == {name != "tight"}
    assert _topo_state(m_c, topo_c) == _topo_state(m_t, topo_t) == _topo_state(m_j, topo_j)
    # a connection after the split lands on the same cells
    for topo in (topo_j, topo_c, topo_t):
        topo.add_connection(0, n_kf - 1, 0.4321)
    assert _topo_state(m_c, topo_c) == _topo_state(m_j, topo_j)


def test_spectral_partition_equals_jax():
    rng = np.random.default_rng(5)
    for n in (4, 9, 16, 30):
        A = rng.uniform(0, 1, (n, n)) ** 4
        A = 0.5 * (A + A.T)
        np.fill_diagonal(A, 0)
        assert t_topo.recursive_spectral_partition(A) == j_topo.recursive_spectral_partition(A)


def test_map_bookkeeping_equals_jax():
    maps = []
    for mod in (t_map, j_map):
        m = mod.Map360()
        for k in range(7):
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = (0.3 * k, 0.1 * k * k, -0.2 * k)
            m.add_keyframe(FakeFrame(), T)
        m.add_connection(2, 5, np.eye(4), np.eye(6) * 3)
        with pytest.raises(AssertionError):
            m.add_connection(5, 2, np.eye(4), np.eye(6))
        maps.append(m)
    a, b = maps
    assert a.trajectory_increments == b.trajectory_increments
    assert [sorted(s) for s in a.areas] == [sorted(s) for s in b.areas]
    assert [a.local_index(k) for k in range(7)] == [b.local_index(k) for k in range(7)]
    np.testing.assert_array_equal(a.connection_kfs[5][2][1], b.connection_kfs[5][2][1])


# -- batch_match -----------------------------------------------------------------------


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _random_pack(rng, n_valid):
    """A packed plane set (batch_match.pack_pbmap's layout) of n_valid
    random planes."""
    k = t_bm.MAX_PLANES
    pack = dict(
        normals=np.zeros((k, 3), np.float32), d=np.zeros(k, np.float32), area=np.zeros(k, np.float32),
        elong=np.ones(k, np.float32), hist=np.zeros((k, HIST_H_BINS), np.float32),
        has_hist=np.zeros(k, bool), valid=np.zeros(k, bool), count=n_valid,
    )
    pack["normals"][:n_valid] = _unit(rng, n_valid)
    pack["d"][:n_valid] = rng.uniform(-3, 3, n_valid)
    pack["area"][:n_valid] = rng.uniform(0.2, 8.0, n_valid)
    pack["elong"][:n_valid] = rng.uniform(1.0, 4.0, n_valid)
    h = rng.uniform(0, 1, (n_valid, HIST_H_BINS)) ** 6
    pack["hist"][:n_valid] = h / h.sum(1, keepdims=True)
    pack["has_hist"][:n_valid] = rng.uniform(size=n_valid) < 0.8
    pack["valid"][:n_valid] = True
    return pack


def _plant_near_thresholds(ref, trg, cfg, side):
    """Make pairs (i, i), i < 6, of ref and trg equal planes but for one
    value each, set 1e-3 (relative) on one side of its threshold: the area
    ratio, the elongation ratio, the Bhattacharyya coefficient, |d1 - d2|,
    the normals' cosine and the up-axis gap."""
    area_thr, elong_thr, hue_thr, dist_d, cos_min = cfg
    f = 1.0 + side * 1e-3
    # two histograms on disjoint supports, mixed to a coefficient of hue_thr
    # / f (the same two for every call: ref is planted once per side)
    fixed = np.random.default_rng(0)
    u = np.zeros(HIST_H_BINS)
    u[:37] = fixed.uniform(0.5, 1, 37)
    w = np.zeros(HIST_H_BINS)
    w[37:] = fixed.uniform(0.5, 1, HIST_H_BINS - 37)
    u, w = u / np.linalg.norm(u), w / np.linalg.norm(w)
    for p in (ref, trg):
        p["normals"][:6], p["d"][:6], p["area"][:6], p["elong"][:6] = (0.0, 1.0, 0.0), 0.7, 2.0, 1.5
        p["hist"][:6], p["has_hist"][:6], p["valid"][:6] = u ** 2, True, True
    trg["area"][0] = 2.0 * area_thr * f
    trg["elong"][1] = 1.5 * elong_thr * f
    bc = hue_thr / f
    trg["hist"][2] = (bc * u + np.sqrt(1 - bc * bc) * w) ** 2
    trg["d"][3] = 0.7 + dist_d * f
    ang = np.arccos(cos_min) * f
    trg["normals"][4] = (0.0, np.cos(ang), np.sin(ang))
    ref["normals"][5] = (0.3, np.sqrt(1 - 0.09), 0.0)
    x = 0.3 + 0.1 * f
    trg["normals"][5] = (x, np.sqrt(1 - x * x), 0.0)


def _near(ref, trg, cfg, tol=1e-6):
    """(i, j, b) entries whose f64 value sits within tol (relative) of a
    threshold: there torch's and XLA's f32 sums may round to either side."""
    area_thr, elong_thr, hue_thr, dist_d, cos_min = cfg
    near = set()
    for b in range(trg["area"].shape[0]):
        a1, a2 = np.maximum(ref["area"][:, None], 1e-6).astype(np.float64), np.maximum(trg["area"][b][None], 1e-6)
        vals = [
            (np.maximum(a1, a2) / np.minimum(a1, a2), area_thr),
            (np.maximum(ref["elong"][:, None], trg["elong"][b][None]) / np.minimum(ref["elong"][:, None], trg["elong"][b][None]), elong_thr),
            (np.sqrt(ref["hist"].astype(np.float64)) @ np.sqrt(trg["hist"][b].astype(np.float64)).T, hue_thr),
            (np.abs(ref["d"][:, None].astype(np.float64) - trg["d"][b][None]), dist_d),
            (ref["normals"].astype(np.float64) @ trg["normals"][b].astype(np.float64).T, cos_min),
            (np.abs(ref["normals"][:, 0, None].astype(np.float64) - trg["normals"][b][None, :, 0]), 0.1),
        ]
        for v, thr in vals:
            for i, j in np.argwhere(np.abs(v - thr) <= tol * abs(thr)):
                near.add((int(i), int(j), b))
    return near


@pytest.mark.parametrize("mode", MODES)
def test_compat_matrices_equal_jax(mode):
    rng = np.random.default_rng(20261016 + mode)
    cfg = t_bm.config_tuple(t_matcher.MatcherConfig())
    ref = _random_pack(rng, 30)
    trg = [_random_pack(rng, n) for n in (0, 7, 30, 48)]
    for side in (-1, 1):  # one candidate on each side of every threshold
        t = _random_pack(rng, 12)
        _plant_near_thresholds(ref, t, cfg, side)
        trg.append(t)
    stacked = t_bm.stack_packs(trg)
    want = np.asarray(jax.vmap(lambda t: j_bm._compat_matrix(
        {k: jnp.asarray(v) for k, v in ref.items() if k != "count"}, t, cfg, mode))(
        {k: jnp.asarray(v) for k, v in stacked.items()}))
    ref_t, trg_t = t_bm.upload_packs(ref, trg, "cpu")
    got = t_bm.compat_matrices(ref_t, trg_t, cfg, mode).numpy()
    assert got.shape == want.shape == (len(trg), t_bm.MAX_PLANES, t_bm.MAX_PLANES)
    assert _near(ref, stacked, cfg) == set()  # no entry within 1e-6 of a threshold
    np.testing.assert_array_equal(got, want)
    # the planted pairs fall on their threshold's side (where the mode
    # checks that threshold), in both packages
    below, above = got[-2], got[-1]
    odometry = mode in (t_matcher.ODOMETRY_6DOF, t_matcher.PLANAR_ODOMETRY_3DOF)
    planar = mode in (t_matcher.PLANAR_3DOF, t_matcher.PLANAR_ODOMETRY_3DOF)
    checked = [True, True, True, odometry, odometry, planar]
    assert below[range(6), range(6)].all()
    np.testing.assert_array_equal(above[range(6), range(6)], [not c for c in checked])
    assert 0.0 < got[3].mean() < 1.0


def test_prefilter_counts_and_areas_equal_jax():
    """prefilter_candidates on random PbMaps (through pack_pbmap's ordering
    and truncation to 48 planes): counts equal, areas within 1e-6
    relative."""
    from rgbd360_torch.core import pbmap as t_pbmap
    from rgbd360_tpu.core import pbmap as j_pbmap

    rng = np.random.default_rng(11)

    def pbmap(n):
        planes = []
        for i in range(n):
            p = j_pbmap.Plane(id=i, normal=_unit(rng, 1)[0], center=rng.uniform(-3, 3, 3),
                              area_hull=float(rng.uniform(0.3, 9.0)), elongation=float(rng.uniform(1, 4)),
                              curvature=float(rng.uniform(0, 0.003)))
            p.d = float(-p.normal @ p.center)
            p.hist_h = j_pbmap.rgb_to_hue_hist(rng.integers(0, 256, (40, 3), dtype=np.uint8))
            planes.append(p)
        return j_pbmap.PbMap(planes)

    frame, cands = pbmap(20), [pbmap(n) for n in (3, 20, 60)]
    cfg = t_matcher.MatcherConfig()
    for mode in MODES:
        counts_t, areas_t = t_bm.prefilter_candidates(
            convert.pbmap_from_numpy(frame), [convert.pbmap_from_numpy(c) for c in cands], cfg, mode, device="cpu")
        counts_j, areas_j = j_bm.prefilter_candidates(frame, cands, cfg, mode)
        np.testing.assert_array_equal(counts_t, counts_j)
        np.testing.assert_allclose(areas_t, areas_j, rtol=1e-6, atol=0)
    assert isinstance(convert.pbmap_from_numpy(frame), t_pbmap.PbMap)
    assert t_bm.prefilter_candidates(convert.pbmap_from_numpy(frame), [], cfg, device="cpu")[0].size == 0
