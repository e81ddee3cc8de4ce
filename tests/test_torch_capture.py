"""The port's live-capture layer against the JAX package's, on the CPU:
the grabber sources and recorder (rgbd360_torch/io/grabber.py against
rgbd360_tpu/io/grabber.py), the grabber app, and the online odometry app
(apps/online_odometry.py, --device cpu; the app's default is the card).

The online odometry runs over the first 3 frames of tools/synthetic_rig.py's
dataset (the construction-spec rig, seeded CLAMS models, a textured room
ray-cast at 6 deg and ~8.4 cm per step). Tolerances, per relative pose:
  * port vs JAX app: 1e-3 m and 0.1 deg (tests/test_torch_odometry.py's
    limit: both run the exact gather on the CPU);
  * port's online app vs the port's odometry app: equal. Both build each
    frame from the same capture (set_raw, undistort, stitch) and seed each
    align with the previous pair's relative pose; the odometry app's
    max_translation_odometry rejection never fires on this dataset.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.apps import grabber as t_grabber  # noqa: E402
from rgbd360_torch.apps import odometry as t_odometry  # noqa: E402
from rgbd360_torch.apps import online_odometry as t_online  # noqa: E402
from rgbd360_torch.io import grabber as tg  # noqa: E402
from rgbd360_tpu.apps import online_odometry as j_online  # noqa: E402
from rgbd360_tpu.io import grabber as jg  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """(calib root, 3-frame sequence dir, ground-truth poses)."""
    d = str(tmp_path_factory.mktemp("rig3"))
    rts = rig.write_calib_root(os.path.join(d, "calib"))
    gt = rig.write_sequence(os.path.join(d, "seq"), rts, frames=3, loops=0.05)
    return os.path.join(d, "calib"), os.path.join(d, "seq"), gt


def _bins(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".bin"))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_source_frames_equal_jax(seed):
    """The procedural frames of a seed are bit-equal in both packages, and
    two seeds give different frames."""
    ours, theirs = list(tg.SyntheticSource(3, seed=seed)), list(jg.SyntheticSource(3, seed=seed))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.rgb.dtype == b.rgb.dtype == np.uint8 and a.depth.dtype == b.depth.dtype == np.uint16
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.depth, b.depth)
        assert a.timestamp == b.timestamp
    other = next(iter(tg.SyntheticSource(1, seed=seed + 1)))
    assert not np.array_equal(other.rgb, ours[0].rgb)


def test_recorder_and_replay_round_trip_byte_equal(tmp_path):
    """Recorded captures replay to the same frames, re-record to the same
    bytes, and equal the JAX recorder's files; each package's ReplaySource
    reads the other's recording."""
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert tg.Recorder(ours).record(tg.SyntheticSource(3, seed=1)) == 3
    assert jg.Recorder(theirs).record(jg.SyntheticSource(3, seed=1)) == 3
    assert _bins(ours) == _bins(theirs) == [f"sphere_images_{n}.bin" for n in (1, 2, 3)]
    for name in _bins(ours):
        assert filecmp.cmp(os.path.join(ours, name), os.path.join(theirs, name), shallow=False)

    again = str(tmp_path / "again")
    assert tg.Recorder(again, first_index=1).record(tg.ReplaySource(ours), max_frames=2) == 2
    assert _bins(again) == ["sphere_images_1.bin", "sphere_images_2.bin"]
    for name in _bins(again):
        assert filecmp.cmp(os.path.join(ours, name), os.path.join(again, name), shallow=False)

    for a, b in zip(tg.ReplaySource(theirs), jg.ReplaySource(ours)):
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.depth, b.depth)
    # first/sample: frames 1 and 3
    assert [f.timestamp for f in tg.ReplaySource(ours, first=1, sample=2)] == [1, 3]


def test_camera_control_semantics_match_jax():
    """RGBDGrabber_OpenNI2.h:84-189: QVGA default, VGA, an invalid mode keeps
    the previous value, shutter in ms (default 10), gain in percent
    (default 100); the same state in both packages after each call."""
    ours, theirs = tg.SyntheticSource(1), jg.SyntheticSource(1)
    state = lambda g: (g.height, g.width, g.get_shutter(), g.get_gain())
    assert state(ours) == state(theirs) == (240, 320, 10, 100)
    for call, arg in [("set_resolution", tg.Grabber.VGA), ("set_resolution", 7), ("set_shutter", 33),
                      ("set_gain", 50), ("set_resolution", tg.Grabber.QVGA), ("set_shutter", 12.9)]:
        getattr(ours, call)(arg)
        getattr(theirs, call)(arg)
        assert state(ours) == state(theirs), (call, arg)
    assert state(ours) == (240, 320, 12, 50)
    assert (tg.Grabber.VGA, tg.Grabber.QVGA) == (0, 1)
    with pytest.raises(NotImplementedError):
        tg.Grabber().grab()


def test_grabber_app_records_and_replays(tmp_path, capsys):
    rec, replay = str(tmp_path / "rec"), str(tmp_path / "replay")
    assert t_grabber.main(["--out", rec, "--synthetic", "3"]) == 0
    assert f"recorded 3 frames -> {rec}" in capsys.readouterr().out
    assert t_grabber.main(["--out", replay, "--replay", rec, "--max-frames", "2"]) == 0
    assert _bins(replay) == ["sphere_images_1.bin", "sphere_images_2.bin"]
    for name in _bins(replay):
        assert filecmp.cmp(os.path.join(rec, name), os.path.join(replay, name), shallow=False)
    with pytest.raises(SystemExit):
        t_grabber.main(["--out", str(tmp_path / "none")])


def test_online_odometry_matches_jax_and_the_odometry_app(dataset, tmp_path, capsys):
    calib, seq, gt = dataset
    out_t, out_j, out_o = (str(tmp_path / k) for k in ("port", "jax", "odometry"))
    assert t_online.main(["--dataset", seq, "--calib-root", calib, "--out", out_t, "--device", "cpu"]) == 0
    assert "3 frames, trajectory length" in capsys.readouterr().out
    assert j_online.main(["--dataset", seq, "--calib-root", calib, "--out", out_j]) == 0
    assert t_odometry.main([seq, "--calib-root", calib, "--out", out_o, "--device", "cpu"]) == 0
    load = lambda d, name: np.loadtxt(os.path.join(d, name)).reshape(-1, 4, 4)
    traj_t, traj_j = load(out_t, "trajectory_online.txt"), load(out_j, "trajectory_online.txt")
    assert len(traj_t) == len(traj_j) == 3
    between = rig.relative_pose_errors(traj_t, traj_j)
    assert (between[:, 0] < 1e-3).all() and (between[:, 1] < 0.1).all(), between
    errs = rig.relative_pose_errors(traj_t, gt)
    assert (errs[:, 0] < rig.GT_T).all() and (errs[:, 1] < rig.GT_ROT_DEG).all(), errs
    np.testing.assert_array_equal(traj_t, load(out_o, "trajectory.txt"))


def test_online_odometry_synthetic_source_and_device_rule(dataset, tmp_path, monkeypatch):
    """--synthetic N runs the procedural stream; without a GPU the default
    device raises rather than falls back to the CPU; no source is an error."""
    calib, _seq, _gt = dataset
    assert t_online.main(["--synthetic", "2", "--calib-root", calib, "--out", str(tmp_path), "--device", "cpu"]) == 0
    assert len(np.loadtxt(tmp_path / "trajectory_online.txt").reshape(-1, 4, 4)) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_online.main(["--synthetic", "2", "--calib-root", calib])
    with pytest.raises(SystemExit):
        t_online.main(["--calib-root", calib, "--device", "cpu"])
