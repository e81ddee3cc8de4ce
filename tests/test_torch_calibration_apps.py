"""The calibration apps of the port (rgbd360_torch/apps/{get_control_planes,
pair_calibrator,online_calibration,eval_calibration,visualize_calibration,
calibrate_laser}.py) against the JAX package's, on the CPU (--device cpu;
the device apps' default is the card), on the same files: the first 3
captures of tests/test_torch_calibration.py's perturbed-rig sequence, with
a calibration root of construction specs.

Tolerances:
  * printouts equal, but for numbers stated here: online_calibration's
    conditioning of a singular 21x21 system (both above 1e15: the ratio of
    the largest singular value to a round-off one); eval_calibration's
    per-pair rotMSE / transMSE within one unit of their printed 6th
    decimal (the control planes' offsets differ by up to 8.4e-5 m,
    tests/test_torch_calibration.py: measured one transMSE a unit apart)
    and its avScoreFitness within 1.5e-3 (load_sequence's avDepth
    tolerance, tests/test_torch_registration_apps.py; the CPU aligns
    differ in their last iterations);
  * get_control_planes' files: the same pairs and rows, normals within
    1e-4 and offsets within 1 mm (tests/test_torch_calibration.py);
    control_planes.npz loads into equal correspondences in both packages,
    and pair_calibrator --planes gives the same printout on either
    package's file;
  * visualize_calibration: the same seam statistics, the same PLY point
    count, both PNGs written at the panorama's size.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.apps import calibrate_laser as t_laser  # noqa: E402
from rgbd360_torch.apps import eval_calibration as t_eval  # noqa: E402
from rgbd360_torch.apps import get_control_planes as t_gcp  # noqa: E402
from rgbd360_torch.apps import online_calibration as t_online  # noqa: E402
from rgbd360_torch.apps import pair_calibrator as t_pair  # noqa: E402
from rgbd360_torch.apps import visualize_calibration as t_vis  # noqa: E402
from rgbd360_torch.core import calibrator as t_cal  # noqa: E402
from rgbd360_tpu.apps import calibrate_laser as j_laser  # noqa: E402
from rgbd360_tpu.apps import eval_calibration as j_eval  # noqa: E402
from rgbd360_tpu.apps import get_control_planes as j_gcp  # noqa: E402
from rgbd360_tpu.apps import online_calibration as j_online  # noqa: E402
from rgbd360_tpu.apps import pair_calibrator as j_pair  # noqa: E402
from rgbd360_tpu.apps import visualize_calibration as j_vis  # noqa: E402
from rgbd360_tpu.core import calibrator as j_cal  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

FRAMES = 3


@pytest.fixture(scope="module")
def rig_data(tmp_path_factory):
    """(calib root, sequence dir): the first 3 of the 6 perturbed-rig
    captures (loops 0.05 over 3 frames = 0.1 over 6)."""
    d = str(tmp_path_factory.mktemp("calibration_apps"))
    rig.write_calib_root(os.path.join(d, "calib"))
    rig.write_sequence(os.path.join(d, "seq"), rig.perturbed_rig(0), frames=FRAMES, loops=0.05)
    return os.path.join(d, "calib"), os.path.join(d, "seq")


def _both(capsys, t_main, j_main, argv, t_extra=(), j_extra=()):
    """Run the port's and the JAX app: ((rc, out) port, (rc, out) JAX)."""
    rc_t = t_main(list(argv) + list(t_extra) + ["--device", "cpu"])
    out_t = capsys.readouterr().out
    rc_j = j_main(list(argv) + list(j_extra))
    out_j = capsys.readouterr().out
    return (rc_t, out_t), (rc_j, out_j)


def test_get_control_planes_matches_jax(rig_data, tmp_path, capsys):
    calib_root, seq = rig_data
    (rc_t, out_t), (rc_j, out_j) = _both(capsys, t_gcp.main, j_gcp.main, [seq, "--calib-root", calib_root],
                                         ["--out", str(tmp_path / "cp_t")], ["--out", str(tmp_path / "cp_j")])
    assert rc_t == rc_j == 0
    assert out_t.replace("cp_t", "") == out_j.replace("cp_j", "")
    assert f"frame {FRAMES}: " in out_t
    names = sorted(os.listdir(tmp_path / "cp_j"))
    assert sorted(os.listdir(tmp_path / "cp_t")) == names and "control_planes.npz" in names
    for name in names:
        if name.endswith(".txt"):
            diff = np.abs(np.loadtxt(tmp_path / "cp_t" / name, ndmin=2) - np.loadtxt(tmp_path / "cp_j" / name, ndmin=2))
            assert diff[:, [0, 1, 2, 4, 5, 6]].max() <= 1e-4 and diff[:, [3, 7]].max() <= 1e-3, name
    for d in ("cp_t", "cp_j"):  # each package's file, loaded by both
        path = str(tmp_path / d / "control_planes.npz")
        a, b = t_gcp.load_correspondences(path), j_gcp.load_correspondences(path)
        assert sorted(a.rows) == sorted(b.rows)
        for key in a.rows:
            np.testing.assert_array_equal(a.matrix(*key), b.matrix(*key))


def test_control_planes_files_cross_load_into_pair_calibrator(rig_data, tmp_path, capsys):
    """control_planes.npz written by either package from the same seeded
    correspondences: pair_calibrator --planes prints the same calibration
    from either file in either package."""
    calib_root, _seq = rig_data
    for d, gcp, cal in (("t", t_gcp, t_cal), ("j", j_gcp, j_cal)):
        corresp = cal.PlaneCorrespondences()
        for obs in rig.control_plane_observations(0):
            corresp.add(*obs)
        gcp.save_correspondences(corresp, str(tmp_path / d))
    outs = []
    for d in ("t", "j"):
        path = str(tmp_path / d / "control_planes.npz")
        for main in (t_pair.main, j_pair.main):
            argv = ["--planes", path, "--pair", "1", "2", "--calib-root", calib_root]
            assert main(argv + (["--device", "cpu"] if main is t_pair.main else [])) == 0
            outs.append(capsys.readouterr().out)
    assert len(set(outs)) == 1 and "Rt estimate for sensor 2 wrt 1" in outs[0]


def test_pair_calibrator_online_matches_jax(rig_data, capsys):
    calib_root, seq = rig_data
    (rc_t, out_t), (rc_j, out_j) = _both(
        capsys, t_pair.main, j_pair.main, ["--dataset", seq, "--pair", "1", "2", "--calib-root", calib_root])
    assert rc_t == rc_j and out_t == out_j
    assert len(re.findall(r"^frame \d+: \d+ correspondences for pair 1-2", out_t, re.M)) == FRAMES


def _cond_free(text):
    """The printout with each conditioning number taken out, and those
    numbers."""
    conds = [float(c) for c in re.findall(r"cond=([0-9.e+]+)", text)]
    return re.sub(r"cond=[0-9.e+]+", "cond=", text), conds


def test_online_calibration_matches_jax(rig_data, tmp_path, capsys):
    calib_root, seq = rig_data
    (rc_t, out_t), (rc_j, out_j) = _both(capsys, t_online.main, j_online.main, [seq, "--calib-root", calib_root],
                                         ["--out", str(tmp_path / "rt_t")], ["--out", str(tmp_path / "rt_j")])
    assert rc_t == rc_j == 0
    (text_t, cond_t), (text_j, cond_j) = _cond_free(out_t.replace("rt_t", "")), _cond_free(out_j.replace("rt_j", ""))
    assert text_t == text_j and len(cond_t) == FRAMES
    for a, b in zip(cond_t, cond_j):
        assert (a > 1e15 and b > 1e15) or a == pytest.approx(b, rel=1e-3), (cond_t, cond_j)
    rt_t = np.stack([np.loadtxt(tmp_path / "rt_t" / f"Rt_0{s + 1}.txt") for s in range(8)])
    rt_j = np.stack([np.loadtxt(tmp_path / "rt_j" / f"Rt_0{s + 1}.txt") for s in range(8)])
    np.testing.assert_allclose(rt_t, rt_j, rtol=0, atol=5e-5)


def test_eval_calibration_matches_jax(rig_data, capsys):
    calib_root, seq = rig_data
    argv = [seq, "--calib-root", calib_root, "--max-frames", "2"]
    (rc_t, out_t), (rc_j, out_j) = _both(capsys, t_eval.main, j_eval.main, argv)
    assert rc_t == rc_j == 0
    (text_t, mse_t, fit_t), (text_j, mse_j, fit_j) = _eval_numbers(out_t), _eval_numbers(out_j)
    assert text_t == text_j and len(mse_t) == 2 * 9 and len(fit_t) == 1
    assert np.abs(mse_t - mse_j).max() <= 1.5e-6
    assert abs(fit_t[0] - fit_j[0]) <= 1.5e-3
    # EvalPairCalibration: one pair, no dense check
    (rc_t, out_t), (rc_j, out_j) = _both(capsys, t_eval.main, j_eval.main, argv + ["--pair", "0", "1"])
    (text_t, mse_t, fit_t), (text_j, mse_j, _f) = _eval_numbers(out_t), _eval_numbers(out_j)
    assert rc_t == rc_j == 0 and text_t == text_j and not fit_t
    assert len(mse_t) == 2 * 2 and np.abs(mse_t - mse_j).max() <= 1.5e-6


def _eval_numbers(text):
    """eval_calibration's printout without its rotMSE / transMSE and
    avScoreFitness numbers, and those numbers."""
    mse = np.array([float(v) for v in re.findall(r"(?:rot|trans)MSE=([0-9.]+)", text)])
    fitness = [float(v) for v in re.findall(r"avScoreFitness .*: ([0-9.]+)", text)]
    text = re.sub(r"((?:rot|trans)MSE=)[0-9.]+", r"\1", re.sub(r"(avScoreFitness .*: )[0-9.]+", r"\1", text))
    return text, mse, fitness


def _ply_points(path):
    with open(path) as f:
        return int(re.search(r"element vertex (\d+)", f.read(4096)).group(1))


def test_visualize_calibration_matches_jax(rig_data, tmp_path, capsys):
    from PIL import Image

    calib_root, seq = rig_data
    argv = [os.path.join(seq, "sphere_images_1.bin"), "--calib-root", calib_root]
    (rc_t, out_t), (rc_j, out_j) = _both(capsys, t_vis.main, j_vis.main, argv,
                                         ["--out", str(tmp_path / "vis_t")], ["--out", str(tmp_path / "vis_j")])
    assert rc_t == rc_j == 0
    assert out_t.replace("vis_t", "") == out_j.replace("vis_j", "")
    assert len(re.findall(r"^seam \d->\d: median depth step", out_t, re.M)) == 8
    assert _ply_points(tmp_path / "vis_t" / "fused_cloud.ply") == _ply_points(tmp_path / "vis_j" / "fused_cloud.ply") > 0
    for name in ("panorama_rgb.png", "panorama_depth.png"):
        with Image.open(tmp_path / "vis_t" / name) as img:
            assert img.size == (1920, 320)


def test_calibrate_laser_app_matches_jax(tmp_path, capsys):
    """--demo and a correspondence file (the demo's rows) print the same in
    both packages, and the demo meets its ground truth."""
    cal, _truth = t_laser.synthetic_rig()
    rows = [np.concatenate([c.normal, [c.d], c.line_dir, c.line_center]) for c in cal.correspondences]
    np.savetxt(tmp_path / "corresp.txt", np.stack(rows))
    outs = []
    for argv in (["--demo"], ["--corresp", str(tmp_path / "corresp.txt")]):
        assert t_laser.main(argv) == 0
        outs.append(capsys.readouterr().out)
        assert j_laser.main(argv) == 0
        assert outs[-1] == capsys.readouterr().out
    dr, dt = (float(x) for x in re.search(r"\|dR\|=(\S+) \|dt\|=(\S+)", outs[0]).groups())
    assert dr < 1e-9 and dt < 1e-9
