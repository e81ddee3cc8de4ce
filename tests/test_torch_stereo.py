"""The stereo frame and the ToF calibrator of the port
(rgbd360_torch/core/frame360_stereo.py, apps/{load_stereo,tof_calibrator}.py,
core/plane_extraction.py::_planes_from_labels) against the JAX package's,
on the CPU.

Inputs: the analytic two-plane panorama of tests/test_components.py:172
(64 x 256) and the room ray-cast in the stereo convention
(tools/synthetic_rig.py::raycast_room_stereo) at 128 x 512 (start_phi 64)
and at the full 180 x 1024 (start_phi 166): at >= 128 x 512 and min_inliers
40 the refinement takes its full (hw+1)-bin branch (KP = hw // 40 + 1 >
512); the ToF demo's three-wall pinhole images.

Tolerances:
  * read/write_stereo_depth across packages, the u16 panorama depth and
    build_sphere_cloud: equal (the cloud's trigonometry is numpy f32 on the
    host in both);
  * the stereo device program stage by stage on the same cloud: normals
    within 1e-5, NaN pattern equal (measured 1.2e-7); segment-stage and
    refined labels equal; the per-label rows' ids and counts equal;
  * get_planes_stereo (the whole chain; JAX's device program computes its
    own cloud with XLA's sin/cos, an ulp from numpy's, which moves single
    pixels across the segmentation's thresholds: measured 1 refined pixel
    at 128 x 512 and at 180 x 1024): the same plane count and order, member
    counts within 2, normals within 1e-4, d within 1 mm, hull areas within
    1%;
  * load_stereo and tof_calibrator --demo: the same printout (but for the
    sign of a normal component that prints as 0.00); the PCD's point count
    and the PNGs equal;
  * planes_from_depth: the same planes, normals within 1e-5, d within
    1e-5 m (the f64 host fit of the same labels; measured ~1e-7).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from rgbd360_torch.apps import load_stereo as t_load  # noqa: E402
from rgbd360_torch.apps import tof_calibrator as t_tof  # noqa: E402
from rgbd360_torch.core import frame360_stereo as t_st  # noqa: E402
from rgbd360_torch.ops import normals as t_nrm  # noqa: E402
from rgbd360_torch.ops import plane_stats as t_ps  # noqa: E402
from rgbd360_torch.ops import planes_seg as t_seg  # noqa: E402
from rgbd360_tpu.apps import load_stereo as j_load  # noqa: E402
from rgbd360_tpu.apps import tof_calibrator as j_tof  # noqa: E402
from rgbd360_tpu.core import frame360_stereo as j_st  # noqa: E402
from rgbd360_tpu.ops import normals as j_nrm  # noqa: E402
from rgbd360_tpu.ops import plane_stats as j_ps  # noqa: E402
from rgbd360_tpu.ops import planes_seg as j_seg  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402


def two_plane_panorama(h=64, w=256, start_phi=166):
    """tests/test_components.py:179-201: two walls, n.x = D on each theta
    half-space. Returns (depth (h,w) f32, [(n, D)])."""
    step = 2 * np.pi / w
    phi = (np.arange(h) + start_phi) * step - np.pi / 2
    theta = np.arange(w) * step - np.pi
    u = np.stack([np.sin(theta)[None, :] * np.cos(phi)[:, None], np.broadcast_to(np.sin(phi)[:, None], (h, w)),
                  np.cos(theta)[None, :] * np.cos(phi)[:, None]], axis=-1)
    planes_gt = [(np.array([0.0, 0.0, 1.0]), 2.0), (np.array([0.0, 0.0, -1.0]), 2.5)]
    depth = np.zeros((h, w), np.float32)
    for half, (n, D) in enumerate(planes_gt):
        sel = (theta >= 0) == bool(half)
        proj = u[:, sel] @ n
        d = np.where(proj > 0.15, D / np.maximum(proj, 0.15), 0.0)
        depth[:, sel] = np.where(d < 14.0, d, 0.0).astype(np.float32)
    return depth, planes_gt


def _write(tmp_path, name, rgb_bgr, depth):
    """A stereo frame's two files: the PNG (RGB) and the raw depth."""
    png, bin_ = str(tmp_path / f"{name}.png"), str(tmp_path / f"{name}.bin")
    Image.fromarray(np.ascontiguousarray(rgb_bgr[..., ::-1])).save(png)
    t_st.write_stereo_depth(bin_, depth)
    return png, bin_


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (png, depth.bin, start_phi)."""
    d = tmp_path_factory.mktemp("stereo")
    rng = np.random.default_rng(0)
    depth, _gt = two_plane_panorama()
    out = {"two_planes": (*_write(d, "two_planes", rng.integers(0, 255, (64, 256, 3), dtype=np.uint8), depth), 166)}
    for name, (h, w, sp) in {"room_128x512": (128, 512, 64), "room_180x1024": (180, 1024, 166)}.items():
        rgb, depth = rig.raycast_room_stereo(rig.stereo_pose(), h, w, sp)
        out[name] = (*_write(d, name, rgb, depth), sp)
    return out


def _frames(scene):
    png, bin_, _sp = scene
    return (t_st.Frame360Stereo(device="cpu").build_stereo(png, bin_), j_st.Frame360Stereo().build_stereo(png, bin_))


def test_stereo_depth_files_cross_packages(tmp_path):
    depth = np.random.default_rng(1).uniform(0.5, 5.0, (90, 512)).astype(np.float32)
    t_st.write_stereo_depth(str(tmp_path / "t.bin"), depth)
    j_st.write_stereo_depth(str(tmp_path / "j.bin"), depth)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    for path in ("t.bin", "j.bin"):
        for mod in (t_st, j_st):
            np.testing.assert_array_equal(mod.read_stereo_depth(str(tmp_path / path)), depth)


@pytest.mark.parametrize("name", ["two_planes", "room_128x512"])
def test_build_and_sphere_cloud_equal_jax(scenes, name):
    ft, fj = _frames(scenes[name])
    np.testing.assert_array_equal(ft.sphere_depth_mm.numpy(), np.asarray(fj.sphere_depth_mm))
    np.testing.assert_array_equal(ft.sphere_rgb.numpy(), np.asarray(fj.sphere_rgb))
    np.testing.assert_array_equal(ft.sphere_gray.numpy(), np.asarray(fj.sphere_gray))
    sp = scenes[name][2]
    (xt, ct), (xj, cj) = ft.build_sphere_cloud(start_phi=sp), fj.build_sphere_cloud(start_phi=sp)
    np.testing.assert_array_equal(xt, np.asarray(xj))
    np.testing.assert_array_equal(ct, np.asarray(cj))


def test_stereo_program_stages_match_jax_on_the_same_cloud(scenes):
    """The 128 x 512 room: the refinement's full-bin branch."""
    ft, _fj = _frames(scenes["room_128x512"])
    xyz = t_st.stereo_cloud(ft.depth_m(), 64)
    h, w = xyz.shape[:2]
    assert h * w // t_st.MIN_INLIERS_STEREO + 1 > 512  # the (hw+1)-bin branch
    x = xyz.numpy()
    nj = np.asarray(j_nrm.organized_normals(jnp.asarray(x), max_depth_change=0.05))
    nt = t_nrm.organized_normals(xyz[None], max_depth_change=0.05)[0].numpy()
    np.testing.assert_array_equal(np.isnan(nt), np.isnan(nj))
    assert np.nanmax(np.abs(nt - nj)) <= 1e-5
    pj = np.asarray(j_seg.segment_planes(jnp.asarray(x), jnp.asarray(nj), angular_threshold=0.05,
                                         distance_threshold=0.05))
    pt = t_seg.segment_planes(xyz[None], torch.from_numpy(nj)[None], angular_threshold=0.05,
                              distance_threshold=0.05)[0].numpy()
    np.testing.assert_array_equal(pt, pj)
    rj = np.asarray(j_seg.refine_plane_labels(jnp.asarray(pj), jnp.asarray(x), None, distance_threshold=0.05,
                                              min_inliers=40))
    rt = t_seg.refine_plane_labels(torch.from_numpy(pj)[None], xyz[None], None, distance_threshold=0.05,
                                   min_inliers=40)[0].numpy()
    np.testing.assert_array_equal(rt, rj)
    assert (rt >= 0).sum() > (pj >= 0).sum()  # the refinement grew regions
    rgb = ft.sphere_rgb
    sj = j_ps.sensor_plane_stats(jnp.asarray(x), jnp.asarray(rgb.numpy()), jnp.asarray(rj), jnp.asarray(pj))
    st = t_ps.sensor_plane_stats(xyz[None], rgb[None], torch.from_numpy(rj)[None], torch.from_numpy(pj)[None])
    np.testing.assert_array_equal(st.label_id[0].numpy(), np.asarray(sj.label_id))
    np.testing.assert_array_equal(st.count[0].numpy(), np.asarray(sj.count))


def _planes_agree(pt, pj):
    assert len(pt.planes) == len(pj.planes) > 0
    for a, b in zip(pt.planes, pj.planes):
        assert abs(a.n_pts - b.n_pts) <= 2
        assert np.abs(a.normal - b.normal).max() <= 1e-4
        assert abs(a.d - b.d) <= 1e-3
        assert abs(a.area_hull - b.area_hull) <= 0.01 * b.area_hull


@pytest.mark.parametrize("name", ["two_planes", "room_128x512"])
def test_get_planes_stereo_matches_jax(scenes, name):
    ft, fj = _frames(scenes[name])
    sp = scenes[name][2]
    pt, pj = ft.get_planes_stereo(start_phi=sp), fj.get_planes_stereo(start_phi=sp)
    assert ft.planes is pt
    _planes_agree(pt, pj)
    if name == "two_planes":  # test_components.py:212-219's recovery
        for n, D in two_plane_panorama()[1]:
            assert any(p.normal @ (-n) > 0.99 and abs(p.d - D) < 0.05 for p in pt.planes)
    else:  # the room's floor, ceiling and walls
        assert len(pt.planes) >= 6


def _pcd_points(path):
    with open(path) as f:
        return int(re.search(r"^POINTS (\d+)$", f.read(4096), re.M).group(1))


def test_load_stereo_app_matches_jax(scenes, tmp_path, capsys):
    png, bin_, _sp = scenes["room_180x1024"]
    assert t_load.main([png, bin_, "--planes", "--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert j_load.main([png, bin_, "--planes", "--out", str(tmp_path / "j")]) == 0
    out_j = capsys.readouterr().out
    # a normal component of +-1e-9 prints as -0.00 in one package and +0.00
    # in the other
    same = lambda text, d: re.sub(r"-(0\.00\b)", r"+\1", text.replace(str(tmp_path / d), ""))
    assert same(out_t, "t") == same(out_j, "j")
    assert "panorama 1024x180" in out_t and len(re.findall(r"^  plane \d+:", out_t, re.M)) >= 6
    assert _pcd_points(tmp_path / "t" / "stereo_cloud.pcd") == _pcd_points(tmp_path / "j" / "stereo_cloud.pcd") > 0
    for name in ("stereo_rgb.png", "stereo_depth.png"):
        with Image.open(tmp_path / "t" / name) as a, Image.open(tmp_path / "j" / name) as b:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_planes_from_depth_matches_jax():
    fx = 90.0
    for rt in (np.eye(4), t_tof.demo_truth()):
        depth = t_tof._synthetic_depth(rt, fx, fx, 79.5, 59.5)
        np.testing.assert_array_equal(depth, j_tof._synthetic_depth(rt, fx, fx, 79.5, 59.5))
        pt = t_tof.planes_from_depth(depth, fx, fx, 79.5, 59.5, "cpu")
        pj = j_tof.planes_from_depth(depth, fx, fx, 79.5, 59.5)
        assert len(pt) == len(pj) == 3
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a.inliers, b.inliers)
            assert np.abs(a.normal - b.normal).max() <= 1e-5 and abs(a.d - b.d) <= 1e-5


def test_tof_calibrator_demo_matches_jax(capsys):
    assert t_tof.main(["--demo", "--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert j_tof.main(["--demo"]) == 0
    assert out_t == capsys.readouterr().out
    dr, dt = (float(x) for x in re.search(r"\|dR\|=(\S+) \|dt\|=(\S+)", out_t).groups())
    assert dr < 1e-4 and dt < 1e-3  # the JAX demo's 2.51e-05 and 3.37e-04


def test_stereo_entry_points_default_to_the_card(scenes, monkeypatch):
    png, bin_, _sp = scenes["two_planes"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = [
        lambda: t_st.Frame360Stereo(),
        lambda: t_load.main([png, bin_, "--out", "unused"]),
        lambda: t_tof.main(["--demo"]),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert t_st.Frame360Stereo(device="cpu").device.type == "cpu"
