"""The sequence apps of the port (rgbd360_torch/apps/{register_graph_sphere,
labelize}.py) against the JAX package's, on the CPU (--device cpu; their
default is the card), on the same files: tools/synthetic_rig.py's 6-frame
sequence (6 deg and ~8.4 cm per step) and its calibration root.

Tolerances:
  * register_graph_sphere: the same pairs, edges and partition, the graph
    poses within 1 mm and the SSO entries within 1e-3 (the dense aligns of
    the two packages agree to ~1e-5 m on the CPU), the relative poses
    within the ground-truth bound of tools/synthetic_rig.py;
  * labelize: the printed counts and labels.json equal.
"""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.apps import labelize as t_labelize  # noqa: E402
from rgbd360_torch.apps import register_graph_sphere as t_graph  # noqa: E402
from rgbd360_tpu.apps import labelize as j_labelize  # noqa: E402
from rgbd360_tpu.apps import register_graph_sphere as j_graph  # noqa: E402
from test_torch_registration_apps import dataset  # noqa: E402,F401
from tools import synthetic_rig as rig  # noqa: E402


def test_register_graph_matches_jax_app(dataset, tmp_path, capsys):
    calib, seq, gt = dataset
    assert t_graph.main([seq, "--calib-root", calib, "--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert j_graph.main([seq, "--calib-root", calib, "--out", str(tmp_path / "jax")]) == 0
    out_j = capsys.readouterr().out
    pairs = lambda text: re.findall(r"^\d+ pairs selected .*$|^loop-closure candidate .*$", text, re.M)
    assert pairs(out_t) == pairs(out_j) == ["5 pairs selected (5 chain, 0 LC)"]
    edges = lambda d: re.findall(r"^EDGE_SE3:QUAT (\d+) (\d+)", (d / "sphere_graph.g2o").read_text(), re.M)
    assert edges(tmp_path / "port") == edges(tmp_path / "jax") and len(edges(tmp_path / "port")) == 5
    for name in ("partition.txt",):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    poses_t, poses_j = (np.loadtxt(d / "graph_poses.txt").reshape(-1, 4, 4) for d in (tmp_path / "port", tmp_path / "jax"))
    np.testing.assert_allclose(poses_t, poses_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port" / "sso.txt"), np.loadtxt(tmp_path / "jax" / "sso.txt"),
                               rtol=0, atol=1e-3)
    errs = rig.relative_pose_errors(poses_t, gt)
    assert (errs[:, 0] < rig.GT_T).all() and (errs[:, 1] < rig.GT_ROT_DEG).all(), errs
    # one chunk of 5 pairs, no padding to the batch of 8
    assert re.findall(r"^registered pairs (\d+)\.\.(\d+) on device \([0-9.]+ ms\)$", out_t, re.M) == [("0", "4")]


def test_labelize_matches_jax_app(dataset, tmp_path, capsys):
    calib, seq, _gt = dataset
    args = [seq, "--labels", "0=wall,1=floor", "--calib-root", calib]
    assert t_labelize.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert j_labelize.main(args + ["--out", str(tmp_path / "jax")]) == 0
    out_j = capsys.readouterr().out
    assert out_t.splitlines()[:6] == out_j.splitlines()[:6]
    labels_t = json.loads((tmp_path / "port" / "labels.json").read_text())
    assert labels_t == json.loads((tmp_path / "jax" / "labels.json").read_text())
    assert len(labels_t) == 6 and all(labels_t.values())
