"""Frame assembly of the port (rgbd360_torch/io, ops/undistort.py,
ops/stitch.py, ops/sphere.py, ops/pinhole.py, core/frame360.py) against the
JAX package, on the CPU.

Inputs are the construction-spec rig (core/calibrator.py), seeded CLAMS
models and room frames ray-cast through the rig (tools/synthetic_rig.py),
so nothing here needs the bundled captures or the shipped calibration.

Tolerances:
  * .bin and CLAMS I/O, fast_stitch, backproject_organized: equal;
  * sphere_cloud_from_image: colours and the NaN pattern equal, points
    within 4 ulp: torch's and XLA's f32 sin/cos round ~5% of the panorama's
    angles to neighbouring floats, and each point is a product of two of
    them;
  * undistort: equal (within 0 ulp; XLA fuses one multiply-add of the
    interpolation, and the port fuses the same one);
  * stitch: equal except where the f32 sampling coordinates land on the
    other side of an integer than JAX's (their sin/cos differ in the last
    ulp): only at pixels whose f64 u or v lies within 1e-4 of an integer,
    or whose f64 depth sample times the obliquity lies within 1e-3 of an
    integer (the u16 truncation), and at no more than 0.01% of the pixels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import room_scene  # noqa: E402
from rgbd360_torch.core.calibrator import construction_specs  # noqa: E402
from rgbd360_torch.core.frame360 import Frame360 as TFrame  # noqa: E402
from rgbd360_torch.io import boost_archive as t_bin  # noqa: E402
from rgbd360_torch.io import clams as t_clams  # noqa: E402
from rgbd360_torch.io import native_loader as t_native  # noqa: E402
from rgbd360_torch.io.calib import Calib360 as TCalib  # noqa: E402
from rgbd360_torch.ops import pinhole as t_pinhole  # noqa: E402
from rgbd360_torch.ops import sphere as t_sphere  # noqa: E402
from rgbd360_torch.ops import stitch as t_stitch  # noqa: E402
from rgbd360_torch.ops import undistort as t_undistort  # noqa: E402
from rgbd360_tpu.core import calibrator as j_calibrator  # noqa: E402
from rgbd360_tpu.core.frame360 import Frame360 as JFrame  # noqa: E402
from rgbd360_tpu.io import boost_archive as j_bin  # noqa: E402
from rgbd360_tpu.io import clams as j_clams  # noqa: E402
from rgbd360_tpu.io.calib import Calib360 as JCalib  # noqa: E402
from rgbd360_tpu.ops import pinhole as j_pinhole  # noqa: E402
from rgbd360_tpu.ops import sphere as j_sphere  # noqa: E402
from rgbd360_tpu.ops import stitch as j_stitch  # noqa: E402
from rgbd360_tpu.ops import undistort as j_undistort  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

POSES = [rig.loop_pose(theta, 0.8) for theta in (0.0, 2.1, 4.3)]


@pytest.fixture(scope="module")
def calib_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("calib"))
    rig.write_calib_root(root, seed=7, spread=0.05)  # multipliers that visibly act
    return root


@pytest.fixture(scope="module")
def calibs(calib_root):
    return TCalib.load(calib_root), JCalib.load(calib_root)


@pytest.fixture(scope="module")
def captures():
    """Room captures through the construction-spec rig at three poses."""
    return [rig.room_capture(p, construction_specs()) for p in POSES]


def test_construction_specs_and_raycaster_are_faithful_copies():
    np.testing.assert_array_equal(construction_specs(), j_calibrator.construction_specs())
    rt = POSES[1] @ construction_specs()[3]
    for got, want in zip(rig.raycast_room_sensor(rt, obstacles=rig.OBSTACLES),
                         room_scene.raycast_room_sensor(rt, obstacles=rig.OBSTACLES)):
        np.testing.assert_array_equal(got, want)


def test_clams_writer_round_trips_through_both_readers(tmp_path):
    model = rig.synthetic_clams_model(3)
    path = str(tmp_path / "distortion_model1")
    rig.write_clams_model(path, model)
    for load in (t_clams.load_clams_model, j_clams.load_clams_model):
        back = load(path)
        assert (back.width, back.height, back.bin_width, back.bin_height, back.bin_depth) == (640, 480, 8, 6, 2.0)
        np.testing.assert_array_equal(back.multipliers, model.multipliers)
        np.testing.assert_array_equal(back.counts, model.counts)
    assert (model.multipliers != 1.0).all()
    with open(path, "r+b") as f:
        f.write(b"X")
    with pytest.raises(ValueError):
        t_clams.load_clams_model(path)


def test_calib360_loads_what_jax_loads(calibs):
    tc, jc = calibs
    np.testing.assert_array_equal(tc.Rt, jc.Rt)
    np.testing.assert_array_equal(tc.Rt_inv, jc.Rt_inv)
    np.testing.assert_array_equal(tc.camera_matrix, jc.camera_matrix)
    for a, b in zip(tc.stacked_intrinsic_arrays()[:2], jc.stacked_intrinsic_arrays()[:2]):
        np.testing.assert_array_equal(a, b)
    mults, counts, geom = tc.device_intrinsic_arrays("cpu")
    assert mults.dtype == torch.float32 and mults.shape == (8, 80, 80, 5)
    assert (geom.bin_width, geom.bin_height) == (4, 3)  # VGA model at QVGA
    assert tc.device_extrinsic_arrays("cpu")[1] is tc.device_extrinsic_arrays("cpu")[1]  # cached


@pytest.mark.parametrize("timestamp", [0, 1234567890123])
def test_bin_writer_byte_equal_to_jax_and_reads_back(tmp_path, captures, timestamp):
    raw = captures[0]
    raw = t_bin.RawFrame360(rgb=raw.rgb, depth=raw.depth, timestamp=timestamp)
    p_t, p_j = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    t_bin.write_frame360_bin(p_t, raw)
    j_bin.write_frame360_bin(p_j, j_bin.RawFrame360(rgb=raw.rgb, depth=raw.depth, timestamp=timestamp))
    with open(p_t, "rb") as a, open(p_j, "rb") as b:
        assert a.read() == b.read()
    readers = [t_bin.read_frame360_bin, j_bin.read_frame360_bin, lambda p: next(t_native.iter_frames([p]))]
    for read in readers:
        back = read(p_t)
        np.testing.assert_array_equal(back.rgb, raw.rgb)
        np.testing.assert_array_equal(back.depth, raw.depth)
        assert back.timestamp == timestamp
    with open(p_t, "r+b") as f:
        f.write(b"\0" * 12)
    with pytest.raises(ValueError):
        t_bin.read_frame360_bin(p_t)


def test_undistort_equals_jax_on_both_branches(calibs, captures):
    tc, jc = calibs
    mults, counts, geom = tc.stacked_intrinsic_arrays()
    kw = dict(bin_width=geom.bin_width, bin_height=geom.bin_height, bin_depth=geom.bin_depth)
    for raw in captures:
        want = np.asarray(j_undistort.undistort_depth_mm(jnp.asarray(raw.depth), jnp.asarray(mults), jnp.asarray(counts), **kw))
        got = t_undistort.undistort_depth_mm(torch.from_numpy(raw.depth), torch.from_numpy(mults), torch.from_numpy(counts), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # the counts put pixels on both branches: interpolated (both bracketing
    # depth bins trained) and nearest-bin
    z = raw.depth.astype(np.float32) * np.float32(0.001)
    idx = np.minimum(4, np.floor(z / 2.0)).astype(np.int32)
    idx1 = np.where(z - 2.0 * idx < 1.0, idx, idx + 1)
    idx0 = idx1 - 1
    cnt = np.repeat(np.repeat(counts, 3, 1), 4, 2)  # (8, 240, 320, 5)
    ok = lambda i: np.take_along_axis(cnt, np.clip(i, 0, 4)[..., None], -1)[..., 0] >= 50
    interpolated = (idx0 >= 0) & (idx1 < 5) & ok(idx0) & ok(idx1) & (z > 0)
    assert 0.2 < interpolated.mean() < 0.9
    scale = got.numpy() / np.where(z > 0, z, 1)
    assert np.abs(scale[z > 0] - 1.0).max() > 0.01  # multipliers != 1 act


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _uv_f64(rt_inv, K):
    """f64 transcription of the stitch's sampling coordinates, per block."""
    rows = np.arange(320, dtype=np.float64)[:, None]
    phi = (159.5 - rows) * 2 * np.pi / 1920
    us, vs = [], []
    for b in range(8):
        rt = rt_inv[7 - b].astype(np.float64)
        theta = (b * 240 + np.arange(240)[None, :] - 1799.5) * 2 * np.pi / 1920
        ray = np.stack([np.broadcast_to(np.sin(phi), (320, 240)), np.cos(phi) * np.sin(theta), np.cos(phi) * np.cos(theta)], -1)
        p = ray @ rt[:3, :3].T + rt[:3, 3]
        us.append(K[0, 0] * p[..., 0] / p[..., 2] + K[0, 2])
        vs.append(K[1, 1] * p[..., 1] / p[..., 2] + K[1, 2])
    stack = lambda x: np.concatenate(x, axis=1)  # (320, 1920)
    return stack(us), stack(vs)


def _near_boundary(depth_sensor_of_pixel, u, v, K):
    near = lambda x, tol: np.abs(x - np.round(x)) < tol
    obliq = np.sqrt(1 + ((u - K[0, 2]) / K[0, 0]) ** 2 + ((v - K[1, 2]) / K[1, 1]) ** 2)
    return near(u, 1e-4) | near(v, 1e-4) | near(depth_sensor_of_pixel * obliq, 1e-3)


def test_stitch_equals_jax_but_at_sampling_boundaries(calibs, captures):
    tc, _jc = calibs
    u, v = _uv_f64(tc.Rt_inv, tc.camera_matrix.astype(np.float64))
    inb = (u >= 0) & (u < 320) & (v >= 0) & (v < 240)
    sensor = np.repeat(7 - np.arange(8), 240)[None, :].repeat(320, 0)
    ui, vi = np.clip(u.astype(int), 0, 319), np.clip(v.astype(int), 0, 239)
    n_diff = n_px = 0
    for raw in captures:
        want_rgb, want_d = [np.asarray(x) for x in j_stitch.stitch_spherical(
            jnp.asarray(raw.rgb), jnp.asarray(raw.depth), jnp.asarray(tc.Rt_inv), jnp.asarray(tc.camera_matrix))]
        got_rgb, got_d = t_stitch.stitch_spherical(
            torch.from_numpy(raw.rgb), torch.from_numpy(raw.depth), torch.from_numpy(tc.Rt_inv), torch.from_numpy(tc.camera_matrix))
        assert got_rgb.dtype == torch.uint8 and got_d.dtype == torch.uint16 and got_d.shape == (320, 1920)
        got_rgb, got_d = got_rgb.numpy(), got_d.numpy()
        diff = (got_rgb != want_rgb).any(-1) | (got_d != want_d)
        d_sample = raw.depth[sensor, vi, ui].astype(np.float64)
        boundary = _near_boundary(d_sample, u, v, tc.camera_matrix.astype(np.float64))
        assert not (diff & ~boundary).any(), np.argwhere(diff & ~boundary)[:5]
        n_diff += diff.sum()
        n_px += diff.size
        assert (got_d > 0).mean() > 0.95 and (got_d[~inb] == 0).all()  # the rig covers the band
    assert n_diff / n_px <= 1e-4, (n_diff, n_px)


def test_fast_stitch_sphere_cloud_and_backprojection_equal_jax(calibs, captures):
    tc, jc = calibs
    raw = captures[1]
    np.testing.assert_array_equal(t_stitch.fast_stitch(torch.from_numpy(raw.rgb)).numpy(),
                                  np.asarray(j_stitch.fast_stitch(jnp.asarray(raw.rgb))))
    rgb, depth = j_stitch.stitch_spherical(jnp.asarray(raw.rgb), jnp.asarray(raw.depth),
                                           jnp.asarray(jc.Rt_inv), jnp.asarray(jc.camera_matrix))
    depth_m = np.asarray(depth).astype(np.float32) * np.float32(0.001)
    want = [np.asarray(x) for x in j_sphere.sphere_cloud_from_image(rgb, jnp.asarray(depth_m))]
    got = [x.numpy() for x in t_sphere.sphere_cloud_from_image(torch.from_numpy(np.array(rgb)), torch.from_numpy(depth_m))]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(want[0]))
    assert np.isnan(got[0]).any() and np.isfinite(got[0]).mean() > 0.9
    fin = np.isfinite(want[0])
    assert _ulps(got[0][fin], want[0][fin]).max() <= 4  # sin/cos: see the module docstring
    d_m = raw.depth.astype(np.float32) * np.float32(0.001)
    d_m[0, :10] = 0.2  # below the valid range
    got = t_pinhole.backproject_organized(torch.from_numpy(d_m)).numpy()
    for s in range(8):
        np.testing.assert_array_equal(got[s], np.asarray(j_pinhole.backproject_organized(jnp.asarray(d_m[s]))))
    assert np.isnan(got[0, :10]).all()


def test_frame360_build_matches_jax_frame360(calibs, captures, tmp_path):
    """Frame360.build (load + undistort + stitch) on a written capture,
    against the JAX Frame360; serialize writes the same bytes back."""
    tc, jc = calibs
    path = str(tmp_path / "sphere_images_1.bin")
    t_bin.write_frame360_bin(path, captures[2])
    ft, fj = TFrame(tc, 1, "cpu").build(path), JFrame(jc, 1).build(path)
    assert ft.rgb.device.type == "cpu" and ft.depth_raw_mm.dtype == torch.uint16
    np.testing.assert_array_equal(ft.depth_undistorted_m.numpy(), np.asarray(fj.depth_undistorted_m))
    diff = (ft.sphere_rgb.numpy() != np.asarray(fj.sphere_rgb)).any(-1) | (ft.sphere_depth_mm.numpy() != np.asarray(fj.sphere_depth_mm))
    assert diff.mean() <= 1e-4
    same = ~diff
    np.testing.assert_array_equal(ft.sphere_gray.numpy()[same], np.asarray(fj.sphere_gray)[same])
    xyz_t, _ = ft.build_sphere_cloud_from_image()
    assert xyz_t.shape == (320, 1920, 3)
    pts_t, rgb_t = ft.build_sphere_cloud_fast()
    pts_j, rgb_j = fj.build_sphere_cloud_fast()
    np.testing.assert_array_equal(rgb_t, rgb_j)
    np.testing.assert_allclose(pts_t, pts_j, rtol=0, atol=1e-6, equal_nan=True)  # a 3-term sum, order may differ
    out = str(tmp_path / "again.bin")
    ft.serialize(out)
    with open(out, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    # the lazy metric depth before undistort is the plain mm -> m conversion
    raw_only = TFrame(tc, 2, "cpu")
    raw_only.set_raw(captures[2])
    np.testing.assert_array_equal(raw_only.depth_undistorted_m.numpy(), captures[2].depth.astype(np.float32) * np.float32(0.001))
    # the plane half (tests/test_torch_planes.py holds it against JAX) runs
    # on the same frame: planes, the fused device program, the keyframe
    assert ft.get_planes(need_inliers=False) is ft.planes
    stats = TFrame(tc, 3, "cpu")
    stats.set_raw(t_bin.read_frame360_bin(path))
    assert stats.build_device_fused().dtype == torch.uint8
    np.testing.assert_array_equal(stats.sphere_depth_mm.numpy(), ft.sphere_depth_mm.numpy())
    assert ft.build_sphere_cloud()[0].shape == (8 * 120 * 160, 3)
    ft.save(str(tmp_path), 1)
    assert TFrame.load_keyframe(tc, str(tmp_path), 1, "cpu").planes is not None
