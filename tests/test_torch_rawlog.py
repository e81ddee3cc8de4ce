"""The port's MRPT rawlog reader/writer (rgbd360_torch/io/rawlog.py) and
rawlog loader (apps/load_rawlog.py, --device cpu) against the JAX
package's, on the CPU.

The reader is gated against tests/golden/minimal_v6.rawlog, which
tests/make_rawlog_fixture.py assembled byte by byte without either
package's writer. The writers are held to each other on the decompressed
stream (the gzip header carries the write time and the file name) and
each package's reader reads the other's files.

The loader runs over tools/synthetic_rig.write_rawlog_sequence's rawlog:
3 frames of RGBD1..RGBD4 (320 x 240, u8 BGR raw CImage, f32 metres) ray-
cast in the room, and one LASER scan per frame that the loader skips.
Tolerances: the raw captures equal; panoramas equal but at no more than
0.01% of the pixels (the stitch's rule in tests/test_torch_frame.py: the
f32 sampling coordinates may land on the other side of an integer than
JAX's, their sin/cos differing in the last ulp); the undistorted sensor
clouds within 1e-6 m but at no more than 0.01% of the points, and those
within 1e-5 m (tests/test_torch_planes.py's limit for these clouds: the
bilateral filter's depths differ by a few ulps; measured 5 of 460,800
points at 1.19e-6 m); planes within the plane parity limits of
tests/test_torch_planes.py (normals 1e-4, d 1 mm, hull area 1%).
"""

import gzip
import io
import os
import random
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.apps import load_rawlog as t_app  # noqa: E402
from rgbd360_torch.core.frame360 import Frame360 as TFrame360  # noqa: E402
from rgbd360_torch.core.pbmap import load_pbmap  # noqa: E402
from rgbd360_torch.io import calib as t_calib  # noqa: E402
from rgbd360_torch.io import rawlog as tr  # noqa: E402
from rgbd360_tpu.apps import load_rawlog as j_app  # noqa: E402
from rgbd360_tpu.io import calib as j_calib  # noqa: E402
from rgbd360_tpu.io import rawlog as jr  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "minimal_v6.rawlog")
STITCH_DIFF_LIMIT = 1e-4  # share of panorama pixels (tests/test_torch_frame.py)


def _assert_panoramas_agree(rgb_a, depth_a, rgb_b, depth_b):
    rgb_a, rgb_b = np.asarray(rgb_a), np.asarray(rgb_b)
    diff = (np.asarray(depth_a) != np.asarray(depth_b))
    diff = diff | ((rgb_a != rgb_b).any(-1) if rgb_a.ndim == 3 else (rgb_a != rgb_b))
    assert diff.mean() <= STITCH_DIFF_LIMIT, int(diff.sum())


@pytest.fixture(scope="module")
def rawlog_dataset(tmp_path_factory):
    """(calibration root, rawlog path) of the 3-frame room rawlog."""
    d = str(tmp_path_factory.mktemp("rawlog"))
    rts = rig.write_calib_root(os.path.join(d, "calib"))
    path = os.path.join(d, "room.rawlog")
    rig.write_rawlog_sequence(path, rts, frames=3)
    return os.path.join(d, "calib"), path


def _fields(obs):
    """Every field of an observation, nested cameras flattened, as numpy."""
    out = {}
    for k, v in vars(obs).items():
        if isinstance(v, (tr.TCamera, jr.TCamera)):
            out.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in vars(v).items()})
        else:
            out[k] = v if v is None else np.asarray(v)
    return out


def _assert_same_observations(a_list, b_list):
    assert [type(o).__name__ for o in a_list] == [type(o).__name__ for o in b_list]
    for a, b in zip(a_list, b_list):
        fa, fb = _fields(a), _fields(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            if fa[k] is None or fb[k] is None:
                assert fa[k] is None and fb[k] is None, k
            else:
                assert fa[k].dtype == fb[k].dtype, k
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_port_reads_the_independent_fixture_as_jax_does():
    ours, theirs = list(tr.read_rawlog(FIXTURE)), list(jr.read_rawlog(FIXTURE))
    assert [type(o).__name__ for o in ours] == ["Obs3DRangeScan", "Obs2DRangeScan", "Obs3DRangeScan"]
    _assert_same_observations(ours, theirs)
    a = ours[0]
    assert a.sensor_label == "RGBD1" and a.timestamp == 129999999990000000
    np.testing.assert_allclose(a.range_image, 1.0 + 0.1 * np.arange(48).reshape(6, 8), rtol=1e-6)
    np.testing.assert_array_equal(a.intensity_image, np.random.default_rng(42).integers(0, 255, (6, 8, 3), np.uint8))


def _mixed_observations(rng):
    """Full v6 records (rotated pose, both TCameras, points, confidence,
    trailing scalars), a minimal one, a grayscale intensity and a v7 laser
    scan with intensities."""
    th = 0.7
    rot = np.eye(4)
    rot[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    rot[:3, 3] = (1.0, -2.0, 0.5)
    cam = tr.TCamera(intrinsics=np.array([[300.0, 0, 160], [0, 301.0, 120], [0, 0, 1]]),
                     dist=np.array([0.1, 0.2, 0.3, 0.4, 0.5]), nrows=12, ncols=16)
    return [
        tr.Obs3DRangeScan(
            sensor_label="RGBD3", timestamp=42, sensor_pose=rot,
            range_image=rng.random((12, 16)).astype(np.float32),
            intensity_image=rng.integers(0, 255, (12, 16, 3), np.uint8),
            confidence_image=rng.integers(0, 255, (12, 16), np.uint8), camera_params=cam,
            points3d=rng.random((5, 3)).astype(np.float32), range_is_depth=False, intensity_image_channel=1,
        ),
        tr.Obs3DRangeScan(sensor_label="RGBD1", timestamp=7,
                          range_image=rng.random((6, 10)).astype(np.float32),
                          intensity_image=rng.integers(0, 255, (6, 10), np.uint8)),
        tr.Obs2DRangeScan(timestamp=9, ranges=rng.random(181).astype(np.float32),
                          intensities=rng.integers(0, 1000, 181).astype(np.int32)),
    ]


def test_writers_agree_and_each_reader_reads_the_other(tmp_path):
    obs_t = _mixed_observations(np.random.default_rng(5))
    obs_j = [
        jr.Obs3DRangeScan(**{k: (jr.TCamera(**vars(v)) if isinstance(v, tr.TCamera) else v) for k, v in vars(o).items()})
        if isinstance(o, tr.Obs3DRangeScan) else jr.Obs2DRangeScan(**vars(o))
        for o in obs_t
    ]
    path_t, path_j = str(tmp_path / "port.rawlog"), str(tmp_path / "jax.rawlog")
    tr.write_rawlog(path_t, obs_t)
    jr.write_rawlog(path_j, obs_j)
    with open(path_t, "rb") as f:
        stream_t = gzip.decompress(f.read())
    with open(path_j, "rb") as f:
        stream_j = gzip.decompress(f.read())
    assert stream_t == stream_j
    back_jt, back_tj = list(jr.read_rawlog(path_t)), list(tr.read_rawlog(path_j))
    _assert_same_observations(back_tj, list(tr.read_rawlog(path_t)))
    _assert_same_observations(back_jt, list(jr.read_rawlog(path_j)))
    np.testing.assert_array_equal(back_tj[0].range_image, obs_t[0].range_image)
    np.testing.assert_allclose(back_tj[0].sensor_pose, obs_t[0].sensor_pose, atol=1e-12)
    np.testing.assert_array_equal(back_jt[2].intensities, obs_t[2].intensities)


def test_garbage_and_unknown_versions_are_refused(tmp_path):
    path = tmp_path / "bad.rawlog"
    with gzip.open(path, "wb") as f:
        f.write(b"\x07garbage\x00junkjunk")
    with pytest.raises(ValueError):
        list(tr.read_rawlog(str(path)))
    name = b"CObservation3DRangeScan"
    path = tmp_path / "bad_version.rawlog"
    with gzip.open(path, "wb") as f:
        f.write(struct.pack("<B", len(name) | 0x80) + name + struct.pack("<b", 8) + b"\x00" * 64)
    with pytest.raises(ValueError, match="version 8"):
        list(tr.read_rawlog(str(path)))
    path = tmp_path / "unknown_class.rawlog"
    with gzip.open(path, "wb") as f:
        f.write(struct.pack("<B", 7 | 0x80) + b"CAction" + struct.pack("<b", 0))
    with pytest.raises(ValueError, match="unsupported rawlog object class"):
        list(tr.read_rawlog(str(path)))
    ext = struct.pack("<B", len("CImage") | 0x80) + b"CImage" + struct.pack("<bB", 9, 1) + struct.pack("<I", 5) + b"a.png\x88"
    with pytest.raises(ValueError, match="externally-stored"):
        tr._read_cimage(io.BytesIO(ext))


def test_truncation_is_refused_as_in_jax(tmp_path):
    """Every mid-stream cut of the fixture, and a clean gzip cut just before
    a nested header, raises ValueError in both packages."""
    with open(FIXTURE, "rb") as f:
        data = f.read()
    rng = random.Random(0)
    cuts = [5, 30, 82, len(data) // 2, len(data) - 2] + [rng.randrange(1, len(data)) for _ in range(5)]
    raw = gzip.decompress(data)
    clean = [raw.index(bytes([len(n) | 0x80]) + n) for n in (b"CPose3D", b"TCamera", b"CImage")]
    blobs = [data[:cut] for cut in cuts] + [gzip.compress(raw[:cut]) for cut in clean]
    for k, blob in enumerate(blobs):
        p = tmp_path / f"cut_{k}.rawlog"
        p.write_bytes(blob)
        for reader in (tr.read_rawlog, jr.read_rawlog):
            with pytest.raises(ValueError):
                list(reader(str(p)))


def test_grouping_decimation_and_ring_poses(rawlog_dataset):
    _calib, path = rawlog_dataset
    ours, theirs = list(t_app.rgbd360_frames(path)), list(j_app.rgbd360_frames(path))
    assert [n for n, _g in ours] == [n for n, _g in theirs] == [0, 1, 2]
    assert [o.sensor_label for o in ours[0][1]] == ["RGBD1", "RGBD2", "RGBD3", "RGBD4"]
    for (_n, a), (_m, b) in zip(ours, theirs):
        _assert_same_observations(a, b)
    assert [n for n, _g in t_app.rgbd360_frames(path, decimation=2)] == [1]
    assert [n for n, _g in t_app.rgbd360_frames(path, decimation=3)] == [2]
    for a, b in zip(t_app.ring_sensor_poses(), j_app.ring_sensor_poses()):
        np.testing.assert_array_equal(a, b)
    assert t_app.SENSOR_ARRANGEMENT == j_app.SENSOR_ARRANGEMENT


def test_frames_panoramas_and_clouds_match_jax(rawlog_dataset):
    """frame360_from_obs + stitch on both packages: the raw captures equal,
    the panoramas by the stitch's rule; the undistorted sphere clouds
    within 1e-6 m but at 0.01% of the points (module docstring)."""
    calib_root, path = rawlog_dataset
    ct, cj = t_calib.Calib360.load(calib_root), j_calib.Calib360.load(calib_root)
    _n, group = next(iter(t_app.rgbd360_frames(path)))
    ft = t_app.frame360_from_obs(ct, group, 0, device="cpu")
    fj = j_app.frame360_from_obs(cj, group, 0)
    assert isinstance(ft, TFrame360) and ft.timestamp == fj.timestamp == group[0].timestamp
    np.testing.assert_array_equal(ft.depth_raw_mm.numpy(), np.asarray(fj.depth_raw_mm))
    np.testing.assert_array_equal(ft.rgb.numpy(), np.asarray(fj.rgb))
    ft.stitch_spherical_image()
    fj.stitch_spherical_image()
    _assert_panoramas_agree(ft.sphere_rgb.numpy(), ft.sphere_depth_mm.numpy(), fj.sphere_rgb, fj.sphere_depth_mm)
    ft.undistort()
    fj.undistort()
    (xyz_t, rgb_t), (xyz_j, rgb_j) = ft.build_sphere_cloud(), fj.build_sphere_cloud()
    np.testing.assert_array_equal(rgb_t, np.asarray(rgb_j))
    xyz_j = np.asarray(xyz_j)
    np.testing.assert_array_equal(np.isnan(xyz_t), np.isnan(xyz_j))
    np.testing.assert_allclose(xyz_t, xyz_j, rtol=0, atol=1e-5, equal_nan=True)
    assert (np.abs(xyz_t - xyz_j) > 1e-6).mean() <= 1e-4
    assert np.isfinite(xyz_t).all(axis=1).mean() > 0.5


def test_load_rawlog_app_modes_match_jax(rawlog_dataset, tmp_path, capsys):
    """The app in its three modes, port (--device cpu) against JAX: the
    panorama PNGs and the saved keyframes' panoramas by the stitch's rule,
    the PLY clouds the same points, the saved planes within the plane
    parity limits."""
    from PIL import Image

    calib_root, path = rawlog_dataset
    run = lambda main, mode, out, *extra: main([path, "--out", str(out), "--mode", mode, "--calib-root", calib_root, *extra])
    for mode in ("images", "cloud", "save"):
        assert run(t_app.main, mode, tmp_path / f"t_{mode}", "--device", "cpu", "--max-frames", "2") == 0
        assert "processed 2 omnidirectional frames" in capsys.readouterr().out
        assert run(j_app.main, mode, tmp_path / f"j_{mode}", "--max-frames", "2") == 0
    png = lambda pkg, kind, n: np.asarray(Image.open(tmp_path / f"{pkg}_images" / f"{kind}_{n:04d}.png"))
    for n in range(2):
        _assert_panoramas_agree(png("t", "rgb", n), png("t", "depth", n), png("j", "rgb", n), png("j", "depth", n))
        ply_t = np.loadtxt(tmp_path / "t_cloud" / f"cloud_{n:04d}.ply", skiprows=10)
        ply_j = np.loadtxt(tmp_path / "j_cloud" / f"cloud_{n:04d}.ply", skiprows=10)
        assert ply_t.shape == ply_j.shape and len(ply_t) > 1000
        np.testing.assert_allclose(ply_t, ply_j, rtol=0, atol=1e-4 + 1e-9)  # printed at 4 decimals
        pt = load_pbmap(str(tmp_path / "t_save" / f"spherePlanes_{n}.pbmap.npz"))
        pj = load_pbmap(str(tmp_path / "j_save" / f"spherePlanes_{n}.pbmap.npz"))
        assert 6 <= len(pt.planes) == len(pj.planes)
        for a, b in zip(pt.planes, pj.planes):
            assert np.abs(a.normal - b.normal).max() < 1e-4
            assert abs(a.d - b.d) < 1e-3
            assert abs(a.area_hull - b.area_hull) <= 0.01 * b.area_hull
        with np.load(tmp_path / "t_save" / f"panorama_{n}.npz") as zt, np.load(tmp_path / "j_save" / f"panorama_{n}.npz") as zj:
            _assert_panoramas_agree(zt["sphere_rgb"], zt["sphere_depth_mm"], zj["sphere_rgb"], zj["sphere_depth_mm"])


def test_load_rawlog_needs_a_card_unless_asked_for_the_cpu(rawlog_dataset, tmp_path, monkeypatch):
    calib_root, path = rawlog_dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_app.main([path, "--out", str(tmp_path), "--calib-root", calib_root])
    empty = tmp_path / "empty.rawlog"
    tr.write_rawlog(str(empty), [])
    assert t_app.main([str(empty), "--out", str(tmp_path), "--calib-root", calib_root, "--device", "cpu"]) == 1
