"""The SLAM apps of the port (rgbd360_torch/apps/{sphere_graph_slam,
kf_sphere_slam,kf_odometry,register_pair}.py) against the JAX package's, on
the CPU (--device cpu; their default is the card), over the 6-frame
sequence of tools/synthetic_rig.py (6 deg and ~8.4 cm per step).

Tolerances (tests/test_torch_slam.py states the reasons): the same
keyframes and tracked-against ids (sphere_graph_slam), the same kinds per
frame (kf_sphere_slam), trajectories within 1 cm; kf_odometry and
register_pair within 1 mm.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.apps import kf_odometry as t_kf_odometry  # noqa: E402
from rgbd360_torch.apps import kf_sphere_slam as t_kf_app  # noqa: E402
from rgbd360_torch.apps import register_pair as t_register_pair  # noqa: E402
from rgbd360_torch.apps import sphere_graph_slam as t_sgs  # noqa: E402
from rgbd360_tpu.apps import kf_odometry as j_kf_odometry  # noqa: E402
from rgbd360_tpu.apps import kf_sphere_slam as j_kf_app  # noqa: E402
from rgbd360_tpu.apps import register_pair as j_register_pair  # noqa: E402
from rgbd360_tpu.apps import sphere_graph_slam as j_sgs  # noqa: E402
from test_torch_slam import _argv, _assert_trajectories_close, _kinds, _sgs_frames, _traj, dataset  # noqa: E402,F401
from tools import synthetic_rig as rig  # noqa: E402


def test_sphere_graph_slam_matches_jax_app(dataset, tmp_path, capsys):
    calib, seq, gt = dataset()
    session = t_sgs.run(_argv(t_sgs.main, seq, calib, "--out", str(tmp_path / "port")))
    out_t = capsys.readouterr().out
    assert j_sgs.main(_argv(j_sgs.main, seq, calib, "--out", str(tmp_path / "jax"))) == 0
    out_j = capsys.readouterr().out
    frames_t, frames_j = _sgs_frames(out_t), _sgs_frames(out_j)
    assert len(frames_t) == len(gt) and frames_t == frames_j
    assert all(kind in ("first", "tracked") for _n, kind, _k, _r in frames_t)
    for name in ("trajectory_slam.txt", "trajectory_optimized.txt"):
        _assert_trajectories_close(_traj(tmp_path / "port" / name), _traj(tmp_path / "jax" / name), 0.01)
    for name in ("pose_graph.g2o", "map.html"):
        assert (tmp_path / "port" / name).stat().st_size > 0
    assert len(session.world) == len(gt) and len(session.optimizer.edges) == len(gt) - 1
    assert session.loop_closer.device.type == "cpu" and session.n_loop_closures == 0
    errs = rig.relative_pose_errors(_traj(tmp_path / "port" / "trajectory_slam.txt"), gt)
    assert (errs[:, 0] < rig.GT_T).all() and (errs[:, 1] < rig.GT_ROT_DEG).all(), errs


def test_kf_sphere_slam_matches_jax_app(dataset, tmp_path, capsys):
    calib, seq, _gt = dataset()
    slam = t_kf_app.run(_argv(t_kf_app.main, seq, calib, "--out", str(tmp_path / "port")))
    out_t = capsys.readouterr().out
    assert j_kf_app.main(_argv(j_kf_app.main, seq, calib, "--out", str(tmp_path / "jax"))) == 0
    out_j = capsys.readouterr().out
    assert _kinds(out_t) == _kinds(out_j) and len(_kinds(out_t)) == 6
    for name in ("trajectory_kf_slam.txt", "trajectory_optimized.txt"):
        _assert_trajectories_close(_traj(tmp_path / "port" / name), _traj(tmp_path / "jax" / name), 0.01)
    spec = slam.speculative_counts
    assert f"speculative aligns: dispatched {spec['dispatched']} consumed {spec['consumed']}" in out_t
    # with speculation off: the same run, no speculative align
    slam_off = t_kf_app.run(_argv(t_kf_app.main, seq, calib, "--no-speculative-align"))
    assert _kinds(capsys.readouterr().out) == _kinds(out_t)
    assert slam_off.speculative_counts["dispatched"] == 0


def test_kf_odometry_matches_jax_app(dataset, tmp_path, capsys):
    calib, seq, gt = dataset()
    assert t_kf_odometry.main(_argv(t_kf_odometry.main, seq, calib, "--out", str(tmp_path / "port"))) == 0
    out_t = capsys.readouterr().out
    assert j_kf_odometry.main(_argv(j_kf_odometry.main, seq, calib, "--out", str(tmp_path / "jax"))) == 0
    out_j = capsys.readouterr().out
    assert re.findall(r"new keyframe|keyframes", out_t) == re.findall(r"new keyframe|keyframes", out_j)
    traj_t, traj_j = _traj(tmp_path / "port" / "trajectory_kf.txt"), _traj(tmp_path / "jax" / "trajectory_kf.txt")
    assert len(traj_t) == len(gt)
    _assert_trajectories_close(traj_t, traj_j, 1e-3)


def _dense_pose(text):
    block = text.split("Dense pose (cloud frame):")[1]
    return np.array([float(x) for x in re.findall(r"-?\d+\.\d*(?:e[-+]\d+)?", block)[:16]]).reshape(4, 4)


def test_register_pair_matches_jax_app(dataset, tmp_path, capsys):
    calib, seq, _gt = dataset()
    frames = [os.path.join(seq, f"sphere_images_{n}.bin") for n in (1, 2)]
    assert t_register_pair.main([*frames, "--calib-root", calib, "--device", "cpu", "--out", str(tmp_path / "port")]) == 0
    out_t = capsys.readouterr().out
    assert j_register_pair.main([*frames, "--calib-root", calib, "--out", str(tmp_path / "jax")]) == 0
    out_j = capsys.readouterr().out
    assert "PbMap matches" in out_t and "PbMap matches" in out_j
    np.testing.assert_allclose(_dense_pose(out_t), _dense_pose(out_j), rtol=0, atol=1e-3)
    for name in ("rgb_frame1.png", "depth_frame2.png", "pair_registered.ply"):
        assert (tmp_path / "port" / name).stat().st_size > 0
    head = lambda p: p.read_text().split("end_header")[0]
    assert head(tmp_path / "port" / "pair_registered.ply") == head(tmp_path / "jax" / "pair_registered.ply")
