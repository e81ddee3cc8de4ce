"""The registration apps of the port (rgbd360_torch/apps/{methods_register,
load_sphere,load_sequence}.py) against the JAX package's, on the CPU
(--device cpu; their default is the card), on the same files:
tools/synthetic_rig.py's 6-frame sequence (6 deg and ~8.4 cm per step) and
its calibration root. register_graph_sphere and labelize are in
tests/test_torch_registration_sequence.py, register_sequence_label in
tests/test_torch_pbmap.py (each file within ~90 s on one worker).

Tolerances:
  * methods_register: each method's translation within 2e-4 m of the JAX
    app's (which prints 4 decimals; the methods agree to ~2e-5 m on the
    CPU), and within 5 mm of the ground truth;
  * load_sphere: the same printout (planes and areas) and PLY point count;
  * load_sequence: |t| and avDepth as printed (2e-4, 1.5e-3), the voxel
    count of the merged cloud within 0.5% (the cloud is placed by the dense
    align).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.apps import load_sequence as t_load_sequence  # noqa: E402
from rgbd360_torch.apps import load_sphere as t_load_sphere  # noqa: E402
from rgbd360_torch.apps import methods_register as t_methods  # noqa: E402
from rgbd360_tpu.apps import load_sequence as j_load_sequence  # noqa: E402
from rgbd360_tpu.apps import load_sphere as j_load_sphere  # noqa: E402
from rgbd360_tpu.apps import methods_register as j_methods  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """(calib root, sequence dir, ground-truth poses) of the 6 frames."""
    d = str(tmp_path_factory.mktemp("registration"))
    rts = rig.write_calib_root(os.path.join(d, "calib"))
    gt = rig.write_sequence(os.path.join(d, "seq"), rts, frames=6)
    return os.path.join(d, "calib"), os.path.join(d, "seq"), gt


def _frame(seq, n):
    return os.path.join(seq, f"sphere_images_{n}.bin")


def _ply_points(path):
    with open(path) as f:
        return int(re.search(r"element vertex (\d+)", f.read(4096)).group(1))


def test_methods_register_matches_jax_app(dataset, capsys):
    calib, seq, gt = dataset
    frames = [_frame(seq, 1), _frame(seq, 2)]
    results = t_methods.run([*frames, "--calib-root", calib, "--device", "cpu"])
    out_t = capsys.readouterr().out
    assert j_methods.main([*frames, "--calib-root", calib]) == 0
    out_j = capsys.readouterr().out
    printed = dict(re.findall(r"^(.+?)\s+t = \[([^\]]+)\]", out_j, re.M))
    truth = np.linalg.inv(gt[0]) @ gt[1]
    assert list(results) == list(printed) and len(results) == 5
    for name, (pose, _ms) in results.items():
        assert pose is not None, name
        t_j = np.array([float(x) for x in printed[name].split()])
        np.testing.assert_allclose(pose[:3, 3], t_j, rtol=0, atol=2e-4, err_msg=name)
        assert np.linalg.norm(pose[:3, 3] - truth[:3, 3]) < 5e-3, name
    assert "max deviation from mean translation" in out_t


def test_loader_apps_match_jax_apps(dataset, tmp_path, capsys):
    calib, seq, _gt = dataset
    sphere = [_frame(seq, 1), "--planes", "--calib-root", calib]
    assert t_load_sphere.main(sphere + ["--out", str(tmp_path / "sphere_t"), "--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert j_load_sphere.main(sphere + ["--out", str(tmp_path / "sphere_j")]) == 0
    out_j = capsys.readouterr().out
    assert out_t.replace("sphere_t", "") == out_j.replace("sphere_j", "")
    for name in ("sphereCloud.ply", "sphereCloud_0.pcd", "rgb_sphere.png", "depth_sphere.png"):
        assert (tmp_path / "sphere_t" / name).stat().st_size > 0
    assert _ply_points(tmp_path / "sphere_t" / "sphereCloud.ply") == _ply_points(tmp_path / "sphere_j" / "sphereCloud.ply")

    sequence = [seq, "--max-frames", "2", "--voxel", "0.1", "--calib-root", calib]
    assert t_load_sequence.main(sequence + ["--out", str(tmp_path / "seq_t"), "--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert j_load_sequence.main(sequence + ["--out", str(tmp_path / "seq_j")]) == 0
    out_j = capsys.readouterr().out
    # printed with 4 (|t|) and 3 (avDepth) decimals
    numbers = lambda text: np.array([float(x) for x in re.findall(r"\|t\|=([0-9.]+) avDepth=([0-9.]+)", text)[0]])
    assert np.all(np.abs(numbers(out_t) - numbers(out_j)) <= [2e-4, 1.5e-3])
    n_t, n_j = (_ply_points(tmp_path / d / "global_map.ply") for d in ("seq_t", "seq_j"))
    assert abs(n_t - n_j) <= 0.005 * n_j and n_j > 0
    assert sorted(os.listdir(tmp_path / "seq_t")) == sorted(os.listdir(tmp_path / "seq_j"))
