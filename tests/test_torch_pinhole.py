"""The pinhole aligner of the port (rgbd360_torch/ops/photoicp_pinhole.py),
its ICP (ops/icp.py) and cloud filters (ops/filter_cloud.py) against the
JAX package, on the CPU, on the same numpy inputs made from a seed.

Tolerances:
  * fused_sweep_pinhole at 24 x 32 (tests/test_pinhole.py:194's scene):
    with the gradient planes rounded to f16 first, JAX's f16 packing of them
    (photoicp_pinhole.py:151-155, not ported: the port gathers f32) is
    lossless, so the term counts are equal and the sums hold to rtol 1e-5
    (atol 1e-5 of the largest entry of H, and for g = J^T r of
    sqrt(max H_ii * max(err2, n)): each residual within 1e-5 of max(1, its
    RMS), for entries that cancel); on
    unrounded gradients H and g hold to 2e-3 of their scale (the precedent of
    tests/test_torch_photoicp.py:145-155: f16 gradients move the Jacobian by
    ~5e-4 relative);
  * the level loop at 120 x 160, 3 levels, on f16-rounded gradient pyramids:
    equal iterations per level and ill_posed, the pose within 1e-4; every
    case takes the Levenberg-Marquardt retry of a rejected first step (the
    robot-frame case: its finest level stops on the noise floor, see the
    test). The alignFrames entry on unrounded inputs: the same on the case that stops
    alike in both (f16 gradients can move a stopping decision elsewhere);
  * ICP on the box scene of tests/test_periphery.py:52: the pose within
    1e-5, equal iterations, inliers within 2;
  * the cloud filters (numpy copies): equal outputs.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ref_impl  # noqa: E402
from rgbd360_torch import convert  # noqa: E402
from rgbd360_torch.ops import filter_cloud as t_filter  # noqa: E402
from rgbd360_torch.ops import icp as t_icp  # noqa: E402
from rgbd360_torch.ops import photoicp as t_photoicp  # noqa: E402
from rgbd360_torch.ops import photoicp_pinhole as tp  # noqa: E402
from rgbd360_tpu.ops import filter_cloud as j_filter  # noqa: E402
from rgbd360_tpu.ops import icp as j_icp  # noqa: E402
from rgbd360_tpu.ops import photoicp as j_photoicp  # noqa: E402
from rgbd360_tpu.ops import photoicp_pinhole as jp  # noqa: E402
from rgbd360_tpu.ops import se3 as j_se3  # noqa: E402
from test_periphery import _box_depth  # noqa: E402
from test_pinhole import _scene, _warp_source  # noqa: E402


def _f16(a):
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def _twist_pose(xi):
    return np.array(j_se3.exp_se3(jnp.asarray(np.array(xi, np.float32)), pseudo=False), np.float32)


def _cam_rt():
    a = np.deg2rad(40.0)
    cam_rt = np.eye(4, dtype=np.float32)
    cam_rt[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    cam_rt[:3, 3] = [0.05, -0.02, 0.1]
    return cam_rt


def _sweep_level(seed, rounded, blob):
    """The 24 x 32 level of tests/test_pinhole.py:194 as eight f32 planes
    (LevelData order). blob: the source holds a near block whose warped
    points land on far target pixels (the z-buffer drops the points behind
    it, Occ2 the ones more than 1 m off the target depth)."""
    rng = np.random.default_rng(seed)
    h, w = 24, 32
    yy, xx = np.mgrid[0:h, 0:w]
    gray = (0.5 + 0.3 * np.sin(xx / 5.0) * np.cos(yy / 4.0) + 0.05 * rng.normal(size=(h, w))).astype(np.float32)
    depth = (2.0 + 0.6 * np.sin(xx / 9.0) + 0.3 * np.cos(yy / 5.0)).astype(np.float32)
    depth[rng.random((h, w)) < 0.05] = 0.0
    depth_src = depth.copy()
    if blob:
        depth_src[8:16, 10:20] = 0.8
    gx, gy = ref_impl.gradient_xy(gray.astype(np.float64))
    dgx, dgy = ref_impl.gradient_xy(depth.astype(np.float64))
    grads = [(_f16 if rounded else np.float32)(g) for g in (gx, gy, dgx, dgy)]
    k = np.array([[30.0, 0, w / 2 - 0.5], [0, 30.0, h / 2 - 0.5], [0, 0, 1]], np.float32)
    return [gray, depth_src, gray, depth] + [np.asarray(g, np.float32) for g in grads], k


def _both_sweeps(planes, k, pose, method, cam_rt, occlusion):
    """(JAX's, the port's) fused_sweep_pinhole outputs as numpy."""
    h, w = planes[0].shape
    level_j = j_photoicp.LevelData(*[jnp.asarray(p) for p in planes])
    xyz, valid = jp.pinhole_lut(level_j.depth_src, jnp.asarray(k), 0)
    out_j = jp.fused_sweep_pinhole(
        level_j.gray_src.reshape(-1), j_photoicp.pack_target_channels(level_j), (h, w), xyz, valid,
        jnp.asarray(pose), jnp.asarray(k), 0, method, None if cam_rt is None else jnp.asarray(cam_rt), occlusion,
    )
    level_t = convert.level_from_numpy(planes, "cpu")
    xyz_t, valid_t = tp.pinhole_lut(level_t.depth_src, torch.from_numpy(k), 0)
    np.testing.assert_array_equal(valid_t[0].numpy(), np.asarray(valid))
    np.testing.assert_array_equal(xyz_t[0].numpy(), np.asarray(xyz))
    out_t = tp.fused_sweep_pinhole(
        level_t.gray_src.reshape(1, -1), t_photoicp.pack_target_planes8(level_t), (h, w), xyz_t, valid_t,
        torch.from_numpy(pose), torch.from_numpy(k), 0, method,
        None if cam_rt is None else torch.from_numpy(cam_rt)[None], occlusion,
    )
    return [np.asarray(x) for x in out_j], [x.numpy() for x in out_t]


def _assert_sums_close(out_j, out_t, tol):
    err2_j, n_j, H_j, g_j, pe_j, np_j, de_j, nd_j = out_j
    err2_t, n_t, H_t, g_t, pe_t, np_t, de_t, nd_t = out_t
    assert (int(n_t), int(np_t), int(nd_t)) == (int(n_j), int(np_j), int(nd_j))
    for a, b in ((err2_t, err2_j), (pe_t, pe_j), (de_t, de_j)):
        assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-9)
    np.testing.assert_allclose(H_t, H_j, rtol=tol, atol=tol * np.abs(H_j).max())
    # g = J^T r: as if each residual agreed within tol of max(1, its RMS).
    # At the identity pose the residuals are the rounding noise of each
    # package's own transform (for cam_rt the round trip R^-1 (R p + t - t)),
    # and so is g
    g_scale = np.sqrt(np.diag(H_j).max() * max(float(err2_j), float(n_j)))
    np.testing.assert_allclose(g_t, g_j, rtol=tol, atol=tol * g_scale)


@pytest.mark.parametrize("robot", [False, True], ids=["single", "cam_rt"])
@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("method", [0, 1, 2])
def test_fused_sweep_matches_jax(method, shift, robot):
    planes, k = _sweep_level(method + 3 * shift, rounded=True, blob=False)
    pose = _twist_pose([0.02, -0.015, 0.03, 0.008, -0.01, 0.012]) if shift else np.eye(4, dtype=np.float32)
    out_j, out_t = _both_sweeps(planes, k, pose, method, _cam_rt() if robot else None, 0)
    assert int(out_t[1]) > 500
    _assert_sums_close(out_j, out_t, 1e-5)


@pytest.mark.parametrize("robot", [False, True], ids=["single", "cam_rt"])
@pytest.mark.parametrize("occlusion", [1, 2])
def test_fused_sweep_occlusion_matches_jax(occlusion, robot):
    planes, k = _sweep_level(7, rounded=True, blob=True)
    pose = _twist_pose([0.02, 0.0, 0.0, 0.0, 0.0, 0.0])
    cam_rt = _cam_rt() if robot else None
    out_j, out_t = _both_sweeps(planes, k, pose, 2, cam_rt, occlusion)
    _assert_sums_close(out_j, out_t, 1e-5)
    # the variants differ on this scene: the z-buffer drops points, Occ2 more
    _pj, plain = _both_sweeps(planes, k, pose, 2, cam_rt, 0)
    _oj, occ1 = _both_sweeps(planes, k, pose, 2, cam_rt, 1)
    assert int(out_t[1]) < int(plain[1])
    assert occlusion == 1 or int(out_t[1]) < int(occ1[1])


def test_fused_sweep_on_unrounded_gradients_within_f16():
    planes, k = _sweep_level(11, rounded=False, blob=False)
    pose = _twist_pose([0.02, -0.015, 0.03, 0.008, -0.01, 0.012])
    out_j, out_t = _both_sweeps(planes, k, pose, 2, None, 0)
    # f16 moves the saliency tests only on gradients within 5e-4 of 0.01
    assert abs(int(out_t[5]) - int(out_j[5])) <= 2 and abs(int(out_t[7]) - int(out_j[7])) <= 2
    for a, b in ((out_t[2], out_j[2]), (out_t[3], out_j[3])):
        np.testing.assert_allclose(a / np.abs(b).max(), b / np.abs(b).max(), rtol=0, atol=2e-3)


# -- the level loop ------------------------------------------------------------------------

H, W = 120, 160
CASES = {  # name: (twist of the true pose, occlusion)
    "plain": ([0.05, -0.04, 0.06, 0.02, -0.03, 0.02], 0),
    "occ1": ([0.1, -0.08, 0.12, 0.05, -0.05, 0.04], 1),
    "occ2": ([0.03, 0.0, 0.0, 0.0, 0.0, 0.0], 2),
}


def _k_small():
    k = np.array([[262.5, 0, 159.5], [0, 262.5, 119.5], [0, 0, 1]], np.float32) * np.float32(W / 320.0)
    k[2, 2] = 1.0
    return k


def _pyramids_rounded(pairs, n_levels):
    """JAX pyramid sets (numpy, a leading camera axis) of (source gray,
    source depth, target gray, target depth) per camera, the target
    gradients rounded to f16."""
    build = functools.partial(j_photoicp.build_pyramid_set, sphere_seam_mask=False)
    srcs = [build(jnp.asarray(sg), jnp.asarray(sd), n_levels, is_target=False) for sg, sd, _g, _d in pairs]
    trgs = [build(jnp.asarray(g), jnp.asarray(d), n_levels, is_target=True) for _sg, _sd, g, d in pairs]
    stack = lambda sets, part, f: [f(np.stack([np.asarray(s[part][lv]) for s in sets])) for lv in range(n_levels)]
    src = tuple(stack(srcs, p, np.asarray) for p in range(2))
    trg = tuple(stack(trgs, p, np.asarray if p < 2 else _f16) for p in range(6))
    return src, trg


def _align_both(src, trg, k, n_levels, occlusion=0, cam_rts=None):
    align = jax.jit(functools.partial(jp.align_frames_pinhole, method=jp.PHOTO_DEPTH, n_levels=n_levels,
                                      occlusion=occlusion))
    res_j = align(src, trg, jnp.asarray(k), jnp.eye(4), cam_rts=None if cam_rts is None else jnp.asarray(cam_rts))
    src_t, trg_t = convert.pyramids_from_numpy(src, trg, "cpu", batched=True)
    tp.reset_sweep_counts()
    res_t = tp.align_frames_pinhole(src_t, trg_t, torch.from_numpy(k), torch.eye(4), tp.PHOTO_DEPTH,
                                    None if cam_rts is None else torch.from_numpy(cam_rts), n_levels,
                                    occlusion=occlusion)
    return res_j, res_t


def _assert_aligns_equal(res_j, res_t, tol):
    np.testing.assert_array_equal(res_t.num_iterations.numpy(), np.asarray(res_j.num_iterations))
    assert bool(res_t.ill_posed) == bool(res_j.ill_posed)
    np.testing.assert_allclose(res_t.pose.numpy(), np.asarray(res_j.pose), rtol=0, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_align_frames_pinhole_matches_jax(case):
    xi, occlusion = CASES[case]
    k = _k_small()
    gray, depth = _scene(H, W)
    src_gray, src_depth = _warp_source(gray, depth, _twist_pose(xi).astype(np.float64), jnp.asarray(k), H, W)
    src, trg = _pyramids_rounded([(src_gray, src_depth, gray, depth)], 3)
    res_j, res_t = _align_both(src, trg, k, 3, occlusion)
    _assert_aligns_equal(res_j, res_t, 1e-4)
    assert not bool(res_t.ill_posed) and int(res_t.num_iterations.sum()) > 0
    # a rejected first step took the Levenberg-Marquardt retry
    assert tp.SWEEPS["lm_retries"] >= 1
    assert np.abs(res_t.pose.numpy() - _twist_pose(xi)).max() < 1e-2


def test_robot_frame_align_matches_jax():
    """Two oppositely mounted cameras and a rig translation
    (tests/test_pinhole.py:84): the damped multi-camera loop. Its
    tolerances (update 1e-6, residual 0.1 on the raw sum) run the finest
    level until a step is rejected, which happens at the noise floor: steps
    of ~1e-5 that move nearest-pixel assignments, decided by the packages'
    last-ulp differences in H (3 of 8 such scenes stop 1-3 iterations apart,
    their poses within 2.6e-5). So the finest level's count is not held."""
    k = _k_small()
    rts = np.stack([np.eye(4), np.diag([1.0, -1.0, -1.0, 1.0])]).astype(np.float32)
    pose_true = np.eye(4)
    pose_true[:3, 3] = [0.015, -0.01, 0.02]
    pairs = []
    for s in range(2):
        gray, depth = _scene(H, W)
        rel = np.linalg.inv(rts[s].astype(np.float64)) @ pose_true @ rts[s]
        pairs.append(_warp_source(gray, depth, rel, jnp.asarray(k), H, W) + (gray, depth))
    src, trg = _pyramids_rounded(pairs, 2)
    res_j, res_t = _align_both(src, trg, k, 2, cam_rts=rts)
    assert int(res_t.num_iterations[0]) == int(res_j.num_iterations[0])
    assert not bool(res_t.ill_posed) and not bool(res_j.ill_posed)
    np.testing.assert_allclose(res_t.pose.numpy(), np.asarray(res_j.pose), rtol=0, atol=1e-4)
    assert np.abs(res_t.pose.numpy() - pose_true).max() < 2e-3


def test_align_frames_entry_matches_jax():
    """The alignFrames entries on unrounded inputs (each package builds its
    own pyramids and gradients)."""
    k = _k_small()
    gray, depth = _scene(H, W)
    xi = [0.01, -0.008, 0.012, 0.004, -0.005, 0.003]
    src_gray, src_depth = _warp_source(gray, depth, _twist_pose(xi).astype(np.float64), jnp.asarray(k), H, W)
    res_j = jp.align_frames_jit(jnp.asarray(src_gray), jnp.asarray(src_depth), jnp.asarray(gray), jnp.asarray(depth),
                                jnp.asarray(k), jnp.eye(4), n_levels=3)
    res_t = tp.align_frames(*(torch.from_numpy(a) for a in (src_gray, src_depth, gray, depth, k)), torch.eye(4),
                            n_levels=3)
    _assert_aligns_equal(res_j, res_t, 1e-4)
    assert np.abs(res_t.pose.numpy() - _twist_pose(xi)).max() < 2e-3


# -- ICP and the cloud filters ---------------------------------------------------------------


@pytest.mark.parametrize("xi", [[0.03, -0.02, 0.04, 0.01, -0.012, 0.008], [0.1, 0.05, -0.08, 0.02, 0.03, -0.05]])
def test_icp_matches_jax(xi):
    h, w = 64, 256
    pose_true = _twist_pose(xi).astype(np.float64)
    depth_trg, depth_src = _box_depth(h, w), _box_depth(h, w, pose_true)
    res_j = j_icp.icp_point_to_plane_sphere(jnp.asarray(depth_src), jnp.asarray(depth_trg), jnp.eye(4))
    res_t = t_icp.icp_point_to_plane_sphere(torch.from_numpy(depth_src), torch.from_numpy(depth_trg), torch.eye(4))
    np.testing.assert_allclose(res_t.pose.numpy(), np.asarray(res_j.pose), rtol=0, atol=1e-5)
    assert res_t.num_iterations == int(res_j.num_iterations)
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= 2
    assert float(res_t.fitness) == pytest.approx(float(res_j.fitness), rel=1e-3)
    assert int(res_t.num_inliers) > 5000 and np.abs(res_t.pose.numpy() - pose_true).max() < 2e-3


def test_target_normals_match_jax():
    depth = _box_depth(32, 128)
    depth[5:9, 40:50] = 0.0  # invalid pixels: their neighbours get no normal
    xyz, valid = j_icp.sphere_xyz_lut(jnp.asarray(depth), 0.3, 10.0)
    n_j, ok_j = j_icp._target_normals_sphere(xyz, valid, 32, 128)
    n_t, ok_t = t_icp._target_normals_sphere(torch.from_numpy(np.array(xyz)), torch.from_numpy(np.array(valid)), 32, 128)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=0, atol=1e-6)
    assert 0 < int(ok_t.sum()) < 32 * 128


def test_filter_cloud_equals_jax():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-5, 5, (4000, 3))
    xyz[::97] = np.nan
    rgb = rng.integers(0, 256, (4000, 3), dtype=np.uint8)
    for got, want in ((t_filter.filter_euclidean(xyz, rgb), j_filter.filter_euclidean(xyz, rgb)),
                      (t_filter.filter_voxel(xyz, rgb, leaf=0.5), j_filter.filter_voxel(xyz, rgb, leaf=0.5))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_filter.filter_voxel(xyz, leaf=0.5), j_filter.filter_voxel(xyz, leaf=0.5))
    np.testing.assert_array_equal(t_filter.filter_euclidean(xyz), j_filter.filter_euclidean(xyz))


def test_entry_points_follow_their_tensors_device():
    """align_frames and icp_point_to_plane_sphere run where their tensors
    are: CPU tensors give CPU results (the card's tensors, the card's)."""
    depth = torch.from_numpy(_box_depth(16, 64))
    res = t_icp.icp_point_to_plane_sphere(depth, depth, torch.eye(4), max_iters=1)
    assert res.pose.device.type == "cpu"
    gray, d = (torch.from_numpy(a) for a in _scene(32, 40))
    out = tp.align_frames(gray, d, gray, d, torch.from_numpy(_k_small()), torch.eye(4), n_levels=1)
    assert out.pose.device.type == "cpu" and out.num_iterations.shape == (1,)
