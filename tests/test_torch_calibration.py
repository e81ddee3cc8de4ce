"""The rig-calibration suite of the port (rgbd360_torch/core/{calibrator,
calibrate_laser}.py, apps/calibrate_rig.py) against the JAX package's, on
the CPU (--device cpu; the apps' default is the card).

Inputs: tools/synthetic_rig.py's 6 room captures ray-cast through a
perturbed rig (perturbed_rig(0): sensors 1-7 each turned by 1 deg about a
random axis and shifted by N(0, 5 mm) per axis), with a calibration root
that holds the construction specs, so the calibration has a real error to
remove; the solvers alone get seeded correspondences. The other
calibration apps are in tests/test_torch_calibration_apps.py (each file
within ~90 s on one worker).

Tolerances:
  * Calibrator (joint rotation GN + translation LS, calibrate_chained),
    PairCalibrator and CalibPairLaserKinect: host float64 copies, equal to
    JAX's to 1e-12 on the same correspondences;
  * gather_control_planes over 3 frames whose planes each package extracted
    itself: the same rows per frame and pair, normals within 1e-4 and
    offsets within 1 mm (the plane layer's tolerances,
    tests/test_torch_planes.py; measured 2.3e-6 and 4.6e-6 m over these 3
    frames, 3.2e-5 and 8.4e-5 m over all 6, each a plane whose two f32
    fits differ);
  * calibrate_rig over the 6 frames: the same printout (per-frame
    control-plane counts, pair conditioning, normal-alignment MSE), the
    Rt_0N.txt files within 5e-5 (measured 2.1e-5: the joint translation
    solve is ill-conditioned on a box room, see ROADMAP queue 3), each file
    loaded by both packages' Calib360; every adjacent relative rotation
    closer to the truth than the construction specs and within 0.6 deg.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.apps import calibrate_laser as t_laser_app  # noqa: E402
from rgbd360_torch.apps import calibrate_rig as t_rig_app  # noqa: E402
from rgbd360_torch.core import calibrate_laser as t_laser  # noqa: E402
from rgbd360_torch.core import calibrator as t_cal  # noqa: E402
from rgbd360_torch.core.frame360 import Frame360 as TFrame  # noqa: E402
from rgbd360_torch.io.calib import Calib360 as TCalib  # noqa: E402
from rgbd360_tpu.apps import calibrate_laser as j_laser_app  # noqa: E402
from rgbd360_tpu.apps import calibrate_rig as j_rig_app  # noqa: E402
from rgbd360_tpu.core import calibrate_laser as j_laser  # noqa: E402
from rgbd360_tpu.core import calibrator as j_cal  # noqa: E402
from rgbd360_tpu.core.frame360 import Frame360 as JFrame  # noqa: E402
from rgbd360_tpu.io.calib import Calib360 as JCalib  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

RT_FILE_LIMIT = 5e-5
ROT_TRUTH_LIMIT_DEG = 0.6


@pytest.fixture(scope="module")
def rig_data(tmp_path_factory):
    """(calib root, sequence dir, the true rig) of the 6 captures."""
    d = str(tmp_path_factory.mktemp("calibration"))
    true = rig.perturbed_rig(0)
    rig.write_calib_root(os.path.join(d, "calib"))
    rig.write_sequence(os.path.join(d, "seq"), true, frames=6)
    return os.path.join(d, "calib"), os.path.join(d, "seq"), true


def seeded_correspondences(mod, seed=0):
    """rig.control_plane_observations(seed) in ``mod``'s PlaneCorrespondences."""
    corresp = mod.PlaneCorrespondences()
    for obs in rig.control_plane_observations(seed):
        corresp.add(*obs)
    return corresp


def _laser_rigs(mod_app, mod_core):
    """The app's demo rig and a second seeded one (test_components.py:81)."""
    cal, truth = mod_app.synthetic_rig(n=24, seed=3)
    rng = np.random.default_rng(5)
    other = mod_core.CalibPairLaserKinect()
    a = 0.25
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.08, 0.02, -0.04])
    for _ in range(10):
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        u = np.cross(n, rng.normal(size=3))
        u /= np.linalg.norm(u)
        p_cam = n * rng.uniform(1.0, 3.0) + np.cross(n, u) * rng.uniform(-1, 1)
        other.add(n, float(n @ p_cam), R.T @ u, R.T @ (p_cam - t))
    return cal, other


@pytest.mark.parametrize("solver", ["joint", "chained", "pair", "laser"])
def test_solvers_match_jax(solver):
    if solver == "laser":
        outs = []
        for cals in (_laser_rigs(t_laser_app, t_laser), _laser_rigs(j_laser_app, j_laser)):
            outs.append([c.calibrate() for c in cals])
        for a, b in zip(*outs):
            assert a is not None and b is not None
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        return
    ct, cj = seeded_correspondences(t_cal), seeded_correspondences(j_cal)
    if solver == "pair":
        init = np.linalg.inv(t_cal.construction_specs()[1]) @ t_cal.construction_specs()[2]
        pt, pj = t_cal.PairCalibrator(), j_cal.PairCalibrator()
        for pc, c in ((pt, ct), (pj, cj)):
            pc.correspondences = c.matrix(1, 2)
            pc.set_init_rt(init)
        a, b = pt.calibrate_pair(), pj.calibrate_pair()
        assert a is not None
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        assert ct.conditioning(1, 2) == pytest.approx(cj.conditioning(1, 2), rel=1e-12)
        return
    kt, kj = t_cal.Calibrator(ct), j_cal.Calibrator(cj)
    if solver == "joint":
        a, b = kt.calibrate(), kj.calibrate()
        assert kt.conditioning == pytest.approx(kj.conditioning, rel=1e-9)
        assert kt.rotation_error2() == pytest.approx(kj.rotation_error2(), rel=1e-12, abs=1e-15)
        assert kt.translation_error2() == pytest.approx(kj.translation_error2(), rel=1e-12, abs=1e-15)
        # the joint solve removes the seeded rig's rotation error
        assert kt.rotation_error2() < t_cal.Calibrator(ct).rotation_error2()
    else:
        a, b = kt.calibrate_chained(), kj.calibrate_chained()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_gather_control_planes_matches_jax(rig_data):
    calib_root, seq, _true = rig_data
    tc, jc = TCalib.load(calib_root), JCalib.load(calib_root)
    init_rt = tc.Rt.astype(np.float64)
    ct, cj = t_cal.PlaneCorrespondences(), j_cal.PlaneCorrespondences()
    for n in (1, 2, 3):
        path = os.path.join(seq, f"sphere_images_{n}.bin")
        ft, fj = TFrame(tc, n, "cpu").build(path), JFrame(jc, n).build(path)
        ft.get_planes()
        fj.get_planes()
        added = (t_rig_app.gather_control_planes(ft, ct, init_rt), j_rig_app.gather_control_planes(fj, cj, init_rt))
        assert added[0] == added[1] > 0, n
    assert sorted(ct.rows) == sorted(cj.rows)
    for key in cj.rows:
        diff = np.abs(ct.matrix(*key) - cj.matrix(*key))
        assert diff[:, [0, 1, 2, 4, 5, 6]].max() <= 1e-4 and diff[:, [3, 7]].max() <= 1e-3, (key, diff)
    assert t_rig_app.eval_calibration(ct, init_rt) == pytest.approx(j_rig_app.eval_calibration(cj, init_rt), rel=1e-4)


def _rot_deg(a, b):
    r = a[:3, :3].T @ b[:3, :3]
    sin = np.linalg.norm([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(sin, (np.trace(r) - 1.0) / 2.0)))


def adjacent_errors(rt, true):
    """(8, 2): per ring pair (s, s+1 mod 8), the rotation (deg) and
    translation (m) between the relative pose of ``rt`` and the truth's."""
    out = []
    for s in range(8):
        s2 = (s + 1) % 8
        est, tru = np.linalg.inv(rt[s]) @ rt[s2], np.linalg.inv(true[s]) @ true[s2]
        out.append((_rot_deg(est, tru), np.linalg.norm(est[:3, 3] - tru[:3, 3])))
    return np.array(out)


def test_calibrate_rig_app_matches_jax(rig_data, tmp_path, capsys):
    calib_root, seq, true = rig_data
    args = [seq, "--calib-root", calib_root]
    assert t_rig_app.main(args + ["--out", str(tmp_path / "rt_t"), "--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert j_rig_app.main(args + ["--out", str(tmp_path / "rt_j")]) == 0
    out_j = capsys.readouterr().out
    assert out_t.replace("rt_t", "") == out_j.replace("rt_j", "")
    assert "frame 6: " in out_t

    loaded = {}
    for name in ("rt_t", "rt_j"):
        for calib_cls in (TCalib, JCalib):
            calib = calib_cls()
            calib.load_extrinsic_calibration(str(tmp_path / name))
            loaded[name, calib_cls] = calib.Rt.astype(np.float64)
        np.testing.assert_array_equal(loaded[name, TCalib], loaded[name, JCalib])
    rt_t, rt_j = loaded["rt_t", TCalib], loaded["rt_j", TCalib]
    np.testing.assert_allclose(rt_t, rt_j, rtol=0, atol=RT_FILE_LIMIT)
    errs, spec = adjacent_errors(rt_t, true), adjacent_errors(t_cal.construction_specs(), true)
    assert (errs[:, 0] < spec[:, 0]).all() and (errs[:, 0] <= ROT_TRUTH_LIMIT_DEG).all(), errs


def test_calibration_apps_default_to_the_card(rig_data, monkeypatch):
    """The device apps run on cuda:0 unless --device names another, and
    raise when there is no GPU."""
    from rgbd360_torch.apps import eval_calibration, get_control_planes, online_calibration, pair_calibrator

    calib_root, seq, _true = rig_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runs = [
        (t_rig_app.main, [seq]), (get_control_planes.main, [seq, "--out", "unused"]),
        (online_calibration.main, [seq]), (eval_calibration.main, [seq]),
        (pair_calibrator.main, ["--dataset", seq, "--pair", "1", "2"]),
    ]
    for main, argv in runs:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--calib-root", calib_root])
