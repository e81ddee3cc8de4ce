"""The SLAM loop of the port against the JAX package, on the CPU: the
keyframe tracker (rgbd360_torch/core/kf_slam.py), map persistence
(core/map_io.py), the entry points and the 40-frame loop of the
SphereGraphSLAM app, each run with --device cpu / device="cpu" (their
default is the card). The apps over the 6-frame sequence are in
tests/test_torch_slam_apps.py, which shares this module's helpers.

Data: tools/synthetic_rig.py's room with two pillars along a circle (the
6-frame sequence of tests/test_torch_odometry.py, 6 deg and ~8.4 cm per
step; the 40-frame loop of the slow test: radius 1.1 m, one loop, 9 deg and
~17 cm per step), and the empty room of tests/test_torch_loop_closure.py for
the tracker's 4-frame scenario (tests/test_kf_slam.py:259).

Tolerances:
  * the tracker: the kinds per frame equal JAX's, trajectories within 1 cm
    (the dense aligns of the two packages agree to a few ulps, and the
    keyframe gates read their results); the speculative run equal to the
    plain run bit for bit, with speculative aligns consumed (> 0);
  * the apps: the same keyframes and tracked-against ids (sphere_graph_slam),
    the same kinds per frame (kf_sphere_slam), trajectories within 1 cm;
    kf_odometry and register_pair within 1 mm (two to five aligns);
  * map_io: a map saved by JAX loads into the port with its poses,
    connections, areas, SSO state and pose graph equal and its panoramas
    byte-equal; a map the port saved loads back equal in both packages;
  * the 40-frame loop (slow: ~2 min of JAX on the CPU): the same number of
    loop closures, the port's ATE no worse than JAX's plus 1 cm, and the
    plane count of each frame, port against JAX.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch import convert  # noqa: E402
from rgbd360_torch.apps import kf_odometry as t_kf_odometry  # noqa: E402
from rgbd360_torch.apps import kf_sphere_slam as t_kf_app  # noqa: E402
from rgbd360_torch.apps import register_pair as t_register_pair  # noqa: E402
from rgbd360_torch.apps import sphere_graph_slam as t_sgs  # noqa: E402
from rgbd360_torch.core import kf_slam as t_kf  # noqa: E402
from rgbd360_torch.core import map_io as t_map_io  # noqa: E402
from rgbd360_torch.io.calib import Calib360 as TCalib  # noqa: E402
from rgbd360_tpu.apps import kf_sphere_slam as j_kf_app  # noqa: E402
from rgbd360_tpu.apps import sphere_graph_slam as j_sgs  # noqa: E402
from rgbd360_tpu.core import kf_slam as j_kf  # noqa: E402
from rgbd360_tpu.core import map_io as j_map_io  # noqa: E402
from rgbd360_tpu.io.calib import Calib360 as JCalib  # noqa: E402
from test_torch_loop_closure import room_frames  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

_DATASETS = {}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """dataset(frames, loops, radius) -> (calib root, sequence dir,
    ground-truth poses); one write per argument set."""

    def make(frames=6, loops=0.1, radius=0.8):
        key = (frames, loops, radius)
        if key not in _DATASETS:
            d = str(tmp_path_factory.mktemp(f"slam{frames}"))
            rts = rig.write_calib_root(os.path.join(d, "calib"))
            gt = rig.write_sequence(os.path.join(d, "seq"), rts, frames=frames, loops=loops, radius=radius)
            _DATASETS[key] = (os.path.join(d, "calib"), os.path.join(d, "seq"), gt)
        return _DATASETS[key]

    return make


def _argv(main, seq, calib, *extra):
    port = main.__module__.startswith("rgbd360_torch")
    return [seq, "--calib-root", calib, *extra] + (["--device", "cpu"] if port else [])


def _traj(path):
    return np.loadtxt(path).reshape(-1, 4, 4)


def _assert_trajectories_close(a, b, tol):
    assert a.shape == b.shape
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() < tol
    assert np.abs(a[:, :3, :3] - b[:, :3, :3]).max() < tol


# -- the keyframe tracker -------------------------------------------------------------


def _pose_y(y):
    p = np.eye(4)
    p[1, 3] = y
    return p


@pytest.fixture(scope="module")
def kf_frames(tmp_path_factory):
    """tests/test_kf_slam.py:279's four room frames (0, 0.12, 0.5, 0.62 m)."""
    root = str(tmp_path_factory.mktemp("kf_room"))
    rig.write_calib_root(root)
    return room_frames(root, [_pose_y(y) for y in (0.0, 0.12, 0.5, 0.62)])


def _run_tracker(module, frames, spec, **kwargs):
    slam = module.KFSphereSLAM(speculative_align=spec, **kwargs)
    kinds = []
    for f in frames:
        if spec:
            slam.prefetch_align(f)  # what planes_pipeline's hook does
        kinds.append(slam.process_frame(f))
    return slam, kinds, np.stack([np.asarray(p, np.float64) for p in slam.world.trajectory_poses])


def test_tracker_matches_jax_and_speculation_is_outcome_identical(kf_frames, monkeypatch):
    """Every frame reaches the dense step (STRONG_PBMAP_MATCHES raised, as
    tests/test_kf_slam.py:272 does): the kinds per frame equal JAX's and
    the trajectories agree within 1 cm; the speculative run equals the
    plain run, and consumed some of its speculative aligns."""
    monkeypatch.setattr(j_kf, "STRONG_PBMAP_MATCHES", 99)
    monkeypatch.setattr(t_kf, "STRONG_PBMAP_MATCHES", 99)
    _slam_j, kinds_j, traj_j = _run_tracker(j_kf, [f[1] for f in kf_frames], False)
    _slam_p, kinds_p, traj_p = _run_tracker(t_kf, [f[0] for f in kf_frames], False, device="cpu")
    slam_s, kinds_s, traj_s = _run_tracker(t_kf, [f[0] for f in kf_frames], True, device="cpu")
    assert kinds_p == kinds_j
    assert "keyframe" in kinds_j and "skip_tracked" in kinds_j  # non-vacuous
    _assert_trajectories_close(traj_p, traj_j, 0.01)
    assert kinds_s == kinds_p
    np.testing.assert_array_equal(traj_s, traj_p)
    counts = slam_s.speculative_counts
    assert counts["consumed"] == slam_s._spec_hits > 0
    assert counts["dispatched"] == counts["consumed"] + counts["wasted"] == len(kf_frames) - 1
    assert _slam_p.speculative_counts == {"dispatched": 0, "consumed": 0, "wasted": 0}


# -- helpers of the app tests (also tests/test_torch_slam_apps.py) ----------------------


_LINE = re.compile(r"^frame (\d+): (?:(first keyframe)|kf (\d+) (tracked vs|RELOCALIZED against kf) (\d+)"
                   r"|(RELOCALIZED against kf) (\d+)|(TRACKING LOST)|(DISCONTINUOUS))", re.M)


def _sgs_frames(text):
    """[(frame, kind, keyframe id, tracked-against id)] of a SphereGraphSLAM
    run's output (the JAX app prints no keyframe id on relocalization, so
    none is kept for it)."""
    out = []
    for m in _LINE.finditer(text):
        if m.group(2):
            out.append((int(m.group(1)), "first", 0, None))
        elif m.group(4) == "tracked vs":
            out.append((int(m.group(1)), "tracked", int(m.group(3)), int(m.group(5))))
        elif m.group(4):
            out.append((int(m.group(1)), "relocalized", None, int(m.group(5))))
        elif m.group(6):
            out.append((int(m.group(1)), "relocalized", None, int(m.group(7))))
        else:
            out.append((int(m.group(1)), "lost", None, None))
    return out


def _kinds(text):
    return re.findall(r"^frame (\d+): (\w+)", text, re.M)


def test_map_saved_by_jax_loads_into_the_port_and_round_trips(dataset, tmp_path, capsys):
    """JAX's kf_sphere_slam saves its map; the port loads it (poses,
    connections, areas, SSO state, graph, keyframe panoramas and planes
    equal), resumes the sequence on it through its own app, saves, and both
    packages load the port's map back equal."""
    calib, seq, _gt = dataset()
    jax_map, port_map = str(tmp_path / "jax_map"), str(tmp_path / "port_map")
    assert j_kf_app.main(_argv(j_kf_app.main, seq, calib, "--save-map", jax_map)) == 0
    world_j, opt_j, topo_j = j_map_io.load_map_full(jax_map, JCalib.load(calib))
    world_t, opt_t, topo_t = t_map_io.load_map_full(jax_map, TCalib.load(calib), "cpu")
    _assert_maps_equal(world_t, opt_t, topo_t, world_j, opt_j, topo_j)

    slam = t_kf_app.run(_argv(t_kf_app.main, seq, calib, "--resume", jax_map, "--save-map", port_map))
    assert f"resumed map: {len(world_j)} keyframes" in capsys.readouterr().out
    assert len(slam.world) >= len(world_j)
    back_t = t_map_io.load_map_full(port_map, TCalib.load(calib), "cpu")
    back_j = j_map_io.load_map_full(port_map, JCalib.load(calib))
    _assert_maps_equal(*back_t, *back_j)
    assert len(back_t[0]) == len(slam.world)
    np.testing.assert_array_equal(np.stack(back_t[0].trajectory_poses), np.stack(slam.world.trajectory_poses))
    world2, opt2 = t_map_io.load_map(port_map, TCalib.load(calib), "cpu")
    assert len(world2) == len(slam.world) and opt2.vertex_count() == len(slam.world)


def _assert_maps_equal(world_t, opt_t, topo_t, world_j, opt_j, topo_j):
    assert len(world_t) == len(world_j) > 0
    np.testing.assert_array_equal(np.stack(world_t.trajectory_poses), np.stack(world_j.trajectory_poses))
    assert world_t.trajectory_increments == world_j.trajectory_increments
    assert [sorted(a) for a in world_t.areas] == [sorted(a) for a in world_j.areas]
    assert world_t.selected_kfs == world_j.selected_kfs and world_t.current_area == world_j.current_area
    assert {k: sorted(v) for k, v in world_t.connection_kfs.items()} == {k: sorted(v) for k, v in world_j.connection_kfs.items()}
    assert [np.asarray(m).tolist() for m in topo_t.v_sso] == [np.asarray(m).tolist() for m in topo_j.v_sso]
    np.testing.assert_array_equal(np.stack(opt_t.vertices), np.stack(opt_j.vertices))
    assert [(e.i, e.j) for e in opt_t.edges] == [(e.i, e.j) for e in opt_j.edges]
    for ft, fj in zip(world_t.frames, world_j.frames):
        assert ft.device.type == "cpu" and (ft.id, ft.node) == (fj.id, fj.node)
        np.testing.assert_array_equal(ft.sphere_rgb.numpy(), np.asarray(fj.sphere_rgb))
        np.testing.assert_array_equal(ft.sphere_depth_mm.numpy(), np.asarray(fj.sphere_depth_mm))
        np.testing.assert_array_equal(ft.sphere_gray.numpy(), np.asarray(fj.sphere_gray))
        assert len(ft.planes) == len(fj.planes) > 0
        for a, b in zip(ft.planes.planes, convert.pbmap_from_numpy(fj.planes).planes):
            np.testing.assert_array_equal(a.normal, b.normal)
            assert a.d == b.d and a.area_hull == b.area_hull


def test_entry_points_default_to_the_card(dataset, monkeypatch):
    """KFSphereSLAM and the four apps run on cuda:0 unless a device is
    named, and raise without a GPU."""
    calib, seq, _gt = dataset()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = os.path.join(seq, "sphere_images_1.bin")
    makers = [
        lambda: t_kf.KFSphereSLAM(),
        lambda: t_sgs.main([seq, "--calib-root", calib]),
        lambda: t_kf_app.main([seq, "--calib-root", calib]),
        lambda: t_kf_odometry.main([seq, "--calib-root", calib]),
        lambda: t_register_pair.main([frame, frame, "--calib-root", calib]),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert t_kf.KFSphereSLAM().aligner.device == torch.device("cuda", 0)


@pytest.mark.slow
def test_forty_frame_loop_matches_jax_app(dataset, tmp_path, capsys, monkeypatch):
    """SphereGraphSLAM over the 40-frame loop (~6.9 m of trajectory, so the
    loop closer's candidates fire on their own), port against JAX: the same
    tracked-against ids and number of loop closures, the port's ATE no worse
    than JAX's plus 1 cm, and the plane count of each frame.

    Measured (CPU): 32 loop closures in both, every one a single-survivor
    refinement against keyframe 2 (the selected keyframe of the area the
    first partition splits off); ATE raw / optimized 177.630 / 177.630 mm
    (port), 177.992 / 177.992 mm (JAX): the robust pose-graph kernel gives
    the closures a weight of ~1e-15 (ROADMAP queue 3)."""
    import rgbd360_torch.core.plane_extraction as t_pe
    import rgbd360_tpu.core.plane_extraction as j_pe

    counts = {"port": [], "jax": []}

    def recording(module, key):
        real = module.planes_pipeline

        def pipeline(*args, **kwargs):
            for frame_no, frame in real(*args, **kwargs):
                counts[key].append(len(frame.planes))
                yield frame_no, frame

        monkeypatch.setattr(module, "planes_pipeline", pipeline)

    recording(t_pe, "port")
    recording(j_pe, "jax")
    monkeypatch.setattr(t_sgs, "planes_pipeline", t_pe.planes_pipeline)
    calib, seq, gt = dataset(40, 1.0, 1.1)
    session = t_sgs.run(_argv(t_sgs.main, seq, calib, "--out", str(tmp_path / "port")))
    out_t = capsys.readouterr().out
    assert j_sgs.main(_argv(j_sgs.main, seq, calib, "--out", str(tmp_path / "jax"))) == 0
    out_j = capsys.readouterr().out
    frames_t, frames_j = _sgs_frames(out_t), _sgs_frames(out_j)
    assert len(frames_t) == 40 and frames_t == frames_j
    n_lc = lambda text: int(re.search(r"(\d+) loop closures", text).group(1))
    assert n_lc(out_t) == n_lc(out_j) == session.n_loop_closures > 0
    ate = {}
    for key in ("port", "jax"):
        for name in ("trajectory_slam", "trajectory_optimized"):
            ate[key, name] = rig.absolute_trajectory_error(_traj(tmp_path / key / f"{name}.txt"), gt)
    print(f"ATE (m): {ate}; planes per frame: port {counts['port']}, jax {counts['jax']}")
    assert ate["port", "trajectory_optimized"] <= ate["jax", "trajectory_optimized"] + 0.01
    assert ate["port", "trajectory_optimized"] <= ate["port", "trajectory_slam"] + 0.005
    # planes per frame: equal but on two frames (23 and 40, measured), where
    # JAX keeps one plane more — the line-like region's plane of
    # test_torch_planes.py::test_get_planes_on_every_frame, which one
    # package's f32 fit keeps and the other's drops
    assert len(counts["port"]) == len(counts["jax"]) == 40
    differ = {n + 1: (a, b) for n, (a, b) in enumerate(zip(counts["port"], counts["jax"])) if a != b}
    assert len(differ) <= 2 and all(b - a == 1 for a, b in differ.values()), differ
