"""PbMap registration of the port (rgbd360_torch/core/{pbmap,matcher,
register_rgbd360}.py, io/ini.py: numpy copies of the JAX package's modules)
against the JAX package, on the CPU; with it the dense 8-camera
registration of RegisterRGBD360 (ops/photoicp_pinhole.py) and the
PbMap-only sequence app (apps/register_sequence_label.py).

Tolerances: on the same planes, everything equal (the host code is a copy);
on each package's own planes of a synthetic pair (tools/synthetic_rig.py's
room, frames 1 and 2), the same best_match, the pose within 1e-5 and the
information matrix within 1e-4 relative to its largest entry; the dense
8-camera pose within 1e-4 (JAX gathers f16 gradients, the port f32).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.apps import register_sequence_label as t_seq_label  # noqa: E402
from rgbd360_torch.core import matcher as t_matcher  # noqa: E402
from rgbd360_torch.core import pbmap as t_pbmap  # noqa: E402
from rgbd360_torch.core import register_rgbd360 as t_reg  # noqa: E402
from rgbd360_torch.core.labelization import labelize_frame, propagate_labels  # noqa: E402
from rgbd360_torch.core.frame360 import Frame360 as TFrame  # noqa: E402
from rgbd360_torch.io import ini as t_ini  # noqa: E402
from rgbd360_torch.io.calib import Calib360 as TCalib  # noqa: E402
from rgbd360_tpu.apps import register_sequence_label as j_seq_label  # noqa: E402
from rgbd360_tpu.core import matcher as j_matcher  # noqa: E402
from rgbd360_tpu.core import pbmap as j_pbmap  # noqa: E402
from rgbd360_tpu.core import register_rgbd360 as j_reg  # noqa: E402
from rgbd360_tpu.core.frame360 import Frame360 as JFrame  # noqa: E402
from rgbd360_tpu.io import ini as j_ini  # noqa: E402
from rgbd360_tpu.io.calib import Calib360 as JCalib  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

MODES = [t_matcher.DEFAULT_6DOF, t_matcher.PLANAR_3DOF, t_matcher.ODOMETRY_6DOF, t_matcher.PLANAR_ODOMETRY_3DOF]


@pytest.fixture(scope="module")
def rig_root(tmp_path_factory):
    """A directory holding calib/ (the calibration root) and seq/ (frames 1
    and 2 of tools/synthetic_rig.py's sequence)."""
    d = str(tmp_path_factory.mktemp("pbmap"))
    rts = rig.write_calib_root(os.path.join(d, "calib"))
    rig.write_sequence(os.path.join(d, "seq"), rts, frames=2, loops=0.1 * 2 / 6)
    return d


@pytest.fixture(scope="module")
def pair(rig_root):
    """((port frame 1, port frame 2), (JAX frame 1, JAX frame 2)) with planes
    (need_inliers=False, the odometry configuration)."""
    d = rig_root
    tc, jc = TCalib.load(os.path.join(d, "calib")), JCalib.load(os.path.join(d, "calib"))
    paths = [os.path.join(d, "seq", f"sphere_images_{n}.bin") for n in (1, 2)]
    port = [TFrame(tc, n, "cpu").build(p) for n, p in zip((1, 2), paths)]
    jax_ = [JFrame(jc, n).build(p) for n, p in zip((1, 2), paths)]
    for f in port + jax_:
        f.get_planes(need_inliers=False)
    return port, jax_


def _as(module, planes):
    """The same planes as ``module``'s Plane objects (a field-for-field copy)."""
    import copy
    import dataclasses

    return module.PbMap([module.Plane(**{f.name: copy.deepcopy(getattr(p, f.name)) for f in dataclasses.fields(p)})
                         for p in planes.planes])


class _Holder:
    def __init__(self, planes):
        self.planes = planes


def test_register_pbmap_on_a_synthetic_pair_matches_jax(pair):
    (t1, t2), (j1, j2) = pair
    rt, rj = t_reg.RegisterRGBD360(), j_reg.RegisterRGBD360()
    assert rt.register_pbmap(t1, t2, 25, t_matcher.PLANAR_3DOF)
    assert rj.register_pbmap(j1, j2, 25, j_matcher.PLANAR_3DOF)
    assert rt.get_matched_planes() == rj.get_matched_planes()
    assert len(rt.best_match) >= 6
    np.testing.assert_allclose(rt.get_pose(), rj.get_pose(), rtol=0, atol=1e-5)
    info_t, info_j = rt.get_info_mat(), rj.get_info_mat()
    np.testing.assert_allclose(info_t, info_j, rtol=0, atol=1e-4 * np.abs(info_j).max())
    assert rt.get_area_matched() == pytest.approx(rj.get_area_matched(), rel=1e-3)
    assert rt.tracking_score() == rj.tracking_score() == t_reg.GOOD
    assert rt.calc_entropy() == pytest.approx(rj.calc_entropy(), abs=1e-2)
    # the pose is the synthetic motion: 6 deg about x and ~8.4 cm, seen
    # through the 157.5 deg sphere/cloud offset
    assert 0.05 < np.linalg.norm(rt.get_pose()[:3, 3]) < 0.12


@pytest.mark.parametrize("mode", MODES)
def test_registration_on_the_same_planes_is_identical(pair, mode):
    (_t1, _t2), (j1, j2) = pair
    rt, rj = t_reg.RegisterRGBD360(), j_reg.RegisterRGBD360()
    ok_t = rt.register_pbmap(_Holder(_as(t_pbmap, j1.planes)), _Holder(_as(t_pbmap, j2.planes)), 25, mode)
    ok_j = rj.register_pbmap(j1, j2, 25, mode)
    assert ok_t == ok_j
    assert rt.best_match == rj.best_match
    np.testing.assert_array_equal(rt.rigid_transf, rj.rigid_transf)
    np.testing.assert_array_equal(rt.information, rj.information)
    assert rt.area_matched == rj.area_matched and rt.area_source == rj.area_source


def test_matcher_fuzz_equals_jax():
    """Random plane sets (transformed copies, perturbed copies and fresh
    planes): the same matches and poses in every mode."""
    rng = np.random.default_rng(20261016)
    for trial in range(20):
        ref, trg = [], []
        for i in range(int(rng.integers(3, 7))):
            n = rng.normal(size=3)
            p = j_pbmap.Plane(id=i, normal=n / np.linalg.norm(n), center=rng.uniform(-3, 3, 3),
                              area_hull=float(rng.uniform(0.5, 6.0)), elongation=float(rng.uniform(1, 3)))
            p.d = float(-p.normal @ p.center)
            p.hist_h = j_pbmap.rgb_to_hue_hist(rng.integers(100, 130, (50, 3), dtype=np.uint8))
            ref.append(p)
        theta = float(rng.uniform(-0.3, 0.3))
        R = np.array([[1, 0, 0], [0, np.cos(theta), -np.sin(theta)], [0, np.sin(theta), np.cos(theta)]])
        t = rng.uniform(-0.3, 0.3, 3)
        for j, p in enumerate(ref):
            q = j_pbmap.Plane(id=j, normal=R @ p.normal, center=R @ p.center + t, area_hull=p.area_hull,
                              elongation=p.elongation, hist_h=p.hist_h.copy())
            if rng.uniform() < 0.3:
                q.normal = q.normal + rng.normal(size=3) * 0.2
                q.normal /= np.linalg.norm(q.normal)
            q.d = float(-q.normal @ q.center)
            trg.append(q)
        jr, jt = j_pbmap.PbMap(ref), j_pbmap.PbMap(trg)
        tr, tt = _as(t_pbmap, jr), _as(t_pbmap, jt)
        idx_r, idx_t = list(range(len(ref))), list(range(len(trg)))
        for mode in MODES:
            m_t = t_matcher.SubgraphMatcher().compare_subgraphs(tr, tt, idx_r, idx_t, mode)
            m_j = j_matcher.SubgraphMatcher().compare_subgraphs(jr, jt, idx_r, idx_t, mode)
            assert m_t == m_j, (trial, mode)
            got = t_matcher.estimate_pose_from_planes(tr, tt, m_t, mode)
            want = j_matcher.estimate_pose_from_planes(jr, jt, m_j, mode)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])


def test_ini_parser_and_matcher_config_equal_jax(tmp_path):
    path = str(tmp_path / "matcher.ini")
    with open(path, "w") as f:
        f.write("// a comment\n% another\nmin_planes_recognition = 4\n[unary] // thresholds\n"
                "dist_d = 0.7 ; inline\nangle=45\nprose line without equals\n[Binary]\n"
                "height_threshold = 0.4 # note\ncos_normal_threshold=0.99\n")
    assert t_ini.parse_ini(path) == j_ini.parse_ini(path)
    ct, cj = t_matcher.MatcherConfig.from_ini(path), j_matcher.MatcherConfig.from_ini(path)
    assert vars(ct) == vars(cj)
    assert (ct.min_planes_recognition, ct.dist_d, ct.angle_deg, ct.height_threshold) == (4, 0.7, 45.0, 0.4)
    empty = str(tmp_path / "empty.ini")
    open(empty, "w").close()
    assert vars(t_matcher.MatcherConfig.from_ini(empty)) == vars(t_matcher.MatcherConfig())
    assert t_reg.RegisterRGBD360(empty).matcher.config == t_matcher.MatcherConfig()


def test_pbmap_geometry_helpers_equal_jax():
    rng = np.random.default_rng(3)
    for n in (3, 7, 40, 300):
        pts = rng.normal(size=(n, 2))
        np.testing.assert_array_equal(t_pbmap.convex_hull_2d(pts), j_pbmap.convex_hull_2d(pts))
        hull = pts[j_pbmap.convex_hull_2d(pts)]
        a_t, c_t = t_pbmap.polygon_area_centroid(hull)
        a_j, c_j = j_pbmap.polygon_area_centroid(hull)
        assert a_t == a_j
        np.testing.assert_array_equal(c_t, c_j)
    segs = [rng.normal(size=(5, 3)) for _ in range(4)]
    np.testing.assert_array_equal(t_pbmap.dist3d_segment_segment_batch(*segs), j_pbmap.dist3d_segment_segment_batch(*segs))
    rgb = rng.integers(0, 256, (500, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_pbmap.rgb_to_hue_hist(rgb), j_pbmap.rgb_to_hue_hist(rgb))


def test_pbmap_files_load_across_packages(pair, tmp_path):
    (t1, _t2), (j1, _j2) = pair
    t_pbmap.save_pbmap(t1.planes, str(tmp_path / "port.pbmap.npz"))
    j_pbmap.save_pbmap(j1.planes, str(tmp_path / "jax.pbmap.npz"))
    for path, src in ((tmp_path / "port.pbmap.npz", t1.planes), (tmp_path / "jax.pbmap.npz", j1.planes)):
        for load in (t_pbmap.load_pbmap, j_pbmap.load_pbmap):
            back = load(str(path))
            assert len(back) == len(src) > 0
            for a, b in zip(back.planes, src.planes):
                np.testing.assert_array_equal(a.normal, b.normal)
                np.testing.assert_array_equal(a.hull, b.hull)
                np.testing.assert_array_equal(a.cov, b.cov)
                assert a.n_pts == b.n_pts and a.area_hull == b.area_hull


def test_register_dense_photoicp_matches_jax(pair):
    """The 8-camera robot-frame registration (ops/photoicp_pinhole.py) at 2
    levels, the method's default (PHOTO_CONSISTENCY): each package reads its
    own frames' raw depth and gray; the pose within 1e-4 of JAX's (JAX's f16
    gradients against the port's f32), the information within 1e-3 of its
    scale."""
    (t1, t2), (j1, j2) = pair
    rt, rj = t_reg.RegisterRGBD360(), j_reg.RegisterRGBD360()
    assert rt.register_dense_photoicp(t1, t2, n_levels=2)
    assert rj.register_dense_photoicp(j1, j2, n_levels=2)
    np.testing.assert_allclose(rt.get_pose(), rj.get_pose(), rtol=0, atol=1e-4)
    info_t, info_j = rt.get_info_mat(), rj.get_info_mat()
    np.testing.assert_allclose(info_t, info_j, rtol=0, atol=1e-3 * np.abs(info_j).max())
    assert rt.ref360 is t1 and rt.trg360 is t2 and rt.get_pose().dtype == np.float32
    # the rig frame's motion: 6 deg about x, ~8.4 cm (rig.loop_pose)
    assert 0.08 < np.linalg.norm(rt.get_pose()[:3, 3]) < 0.09


def test_register_sequence_label_matches_jax_app(pair, rig_root, tmp_path, capsys):
    """RegisterSequenceSphere_labelFast over keyframes the port saved
    (Frame360.save): keyframe 1 labelized, 2 with the labels propagated, 3
    (frame 2 again) with none, which the app skips. PbMap registration is
    host code copied from the JAX package: the printout (times aside) and
    the trajectory equal, the merged cloud's point count equal."""
    import copy
    import re

    (t1, t2), _ = pair
    kfs = [copy.copy(f) for f in (t1, t2, t2)]
    for f in kfs:
        f.planes = copy.deepcopy(f.planes)  # the fixture's planes stay unlabeled
    assert labelize_frame(kfs[0], {0: "wall", 1: "floor"}) == 2
    assert propagate_labels(kfs[0], kfs[1], t_reg.RegisterRGBD360()) == 2
    kf_dir = tmp_path / "kfs"
    kf_dir.mkdir()
    for n, f in enumerate(kfs, start=1):
        f.save(str(kf_dir), n)
    calib = os.path.join(rig_root, "calib")
    stats = t_seq_label.run(str(kf_dir), str(tmp_path / "port"), calib_root=calib, device="cpu")
    out_t = capsys.readouterr().out
    assert j_seq_label.main([str(kf_dir), "--out", str(tmp_path / "jax"), "--calib-root", calib]) == 0
    out_j = capsys.readouterr().out
    assert "frame 3: NO LABELS" in out_t and (stats["labelized"], stats["unlabelized"]) == (1, 1)
    strip_ms = lambda text: re.sub(r"T=[0-9.]+ ms|avTime [0-9.]+ ms", "", text)
    assert strip_ms(out_t) == strip_ms(out_j)
    traj_t, traj_j = (np.loadtxt(tmp_path / d / "trajectory.txt") for d in ("port", "jax"))
    np.testing.assert_array_equal(traj_t, traj_j)
    assert 0.05 < np.linalg.norm(traj_t.reshape(-1, 4, 4)[1, :3, 3]) < 0.12
    points = lambda d: int(re.search(r"element vertex (\d+)", (tmp_path / d / "global_map.ply").read_text()).group(1))
    assert points("port") == points("jax") > 0


def test_accessors_register_lazily_and_failures_score_bad(pair):
    (t1, t2), _ = pair
    reg = t_reg.RegisterRGBD360()
    reg.set_reference(t1, 25)
    reg.set_target(t2, 25)
    assert reg.tracking_score() == t_reg.BAD  # never registered
    pose = reg.get_pose()  # runs register_pbmap (DEFAULT_6DOF)
    assert pose.shape == (4, 4) and reg.best_match
    one_plane = _Holder(t_pbmap.PbMap(t1.planes.planes[:1]))
    fresh = t_reg.RegisterRGBD360()
    assert not fresh.register_pbmap(one_plane, one_plane, 25, t_matcher.PLANAR_3DOF)
    assert fresh.tracking_score() == t_reg.BAD
