"""The port's dense spherical aligner (rgbd360_torch/ops/photoicp.py,
parallel/batch.py, convert.py) against the JAX package, on the CPU.

  * fused_sweep_sphere, windowed branch (plain gather, routing forced)
    against JAX's kernel branch with the Pallas kernel in interpret mode;
    exact branch against JAX's XLA branch;
  * the three golden gates of tests/test_golden_parity.py, run on the port
    with the same tolerances;
  * align_batch against JAX's align_batch on the golden pair;
  * JAX-built pyramids through convert.py into the port's aligner;
  * the vmap-of-while semantics of the batched Gauss-Newton loop;
  * the windowed route at full resolution on the golden pair, held to
    bench.sanity_check(kernel_path=True): the CPU preview of what the card
    must print;
  * the same on the single-buffer route (PIPELINE_KERNEL = False): the
    windowed sweep at the golden fixed poses against JAX's with its
    ``_kernel`` in interpret mode, and a free align held to the same rails.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import bench  # noqa: E402
import golden_ref  # noqa: E402
from rgbd360_torch import convert  # noqa: E402
from rgbd360_torch.ops import image as t_image  # noqa: E402
from rgbd360_torch.ops import linalg6 as t_linalg6  # noqa: E402
from rgbd360_torch.ops import photoicp as tp  # noqa: E402
from rgbd360_torch.ops import se3 as t_se3  # noqa: E402
from rgbd360_torch.ops import warp_gather as tw  # noqa: E402
from rgbd360_torch.ops.sphere import sphere_xyz_lut as t_lut  # noqa: E402
from rgbd360_torch.parallel.batch import align_batch as t_align_batch  # noqa: E402
from rgbd360_tpu.ops import photoicp as jp  # noqa: E402
from rgbd360_tpu.ops import warp_gather as jw  # noqa: E402
from rgbd360_tpu.ops.sphere import sphere_xyz_lut as j_lut  # noqa: E402
from rgbd360_tpu.parallel.batch import align_batch as j_align_batch  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pair_1_10.npz")
STATE = ["error", "H", "g", "sso", "pe2", "n_photo", "de2", "n_depth"]


@pytest.fixture()
def interpret_kernel():
    """JAX's pl.pallas_call in interpret mode (tests/test_warp_kernel_interpret.py:33)."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl.pallas_call = patched
    jw.warp_gather_batched.clear_cache()
    jw.warp_gather_batched_multi.clear_cache()
    yield
    pl.pallas_call = orig
    jw.warp_gather_batched.clear_cache()
    jw.warp_gather_batched_multi.clear_cache()


@pytest.fixture()
def windowed_route(monkeypatch):
    """Force the windowed route on the CPU: the routing predicate is the only
    switch (the JAX suite forces its own the same way). On a CPU tensor the
    warp gather then runs its plain version."""
    monkeypatch.setattr(tp, "_use_warp_kernel", lambda shape, device: shape[0] * shape[1] >= tp.WARP_KERNEL_MIN_PIXELS)


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_level(seed, h=32, w=128):
    """A small random spherical level with strong gradients (saliency passes
    almost everywhere), as numpy fields of LevelData."""
    rng = np.random.default_rng(seed)
    mk = lambda lo, hi: rng.uniform(lo, hi, size=(h, w)).astype(np.float32)
    g = lambda: (rng.uniform(0.05, 0.5, size=(h, w)) * rng.choice([-1.0, 1.0], size=(h, w))).astype(np.float32)
    return jp.LevelData(
        gray_src=mk(0.2, 0.8), depth_src=mk(1.5, 3.5), gray_trg=mk(0.2, 0.8), depth_trg=mk(1.5, 3.5),
        gray_trg_gx=g(), gray_trg_gy=g(), depth_trg_gx=g(), depth_trg_gy=g(),
    )


def _sweep_pair(level_np, pose, *, windowed, occlusion=0, two_pass=False, stats_only=False):
    """The same sweep on both packages: JAX's kernel branch (planes8) or XLA
    branch (packed rows), and the port's windowed or exact branch."""
    h, w = level_np.gray_src.shape
    lj = jp.LevelData(*[jnp.asarray(f) for f in level_np])
    xyz, valid = j_lut(lj.depth_src, jp.MIN_DEPTH, jp.MAX_DEPTH)
    packed = jp.pack_target_planes8(lj) if windowed else jp.pack_target_channels(lj)
    want = [np.asarray(x) for x in jp.fused_sweep_sphere(
        lj.gray_src.reshape(-1), packed, (h, w), xyz, valid, jnp.asarray(pose), jp.PHOTO_DEPTH,
        occlusion, two_pass=two_pass, stats_only=stats_only,
    )]
    lt = convert.level_from_numpy(level_np, "cpu")
    xyz_t, valid_t = t_lut(lt.depth_src, tp.MIN_DEPTH, tp.MAX_DEPTH)
    got = [x[0].numpy() for x in tp.fused_sweep_sphere(
        lt.gray_src.reshape(1, -1), tp.pack_target_planes8(lt), (h, w), xyz_t, valid_t,
        convert.pose_from_numpy(pose, "cpu"), tp.PHOTO_DEPTH, occlusion,
        two_pass=two_pass, stats_only=stats_only, windowed=windowed,
    )]
    return got, want


def _assert_state_close(got, want, atol_of_scale):
    for a, b, name in zip(got, want, STATE):
        if name in ("n_photo", "n_depth"):
            assert int(a) == int(b), (name, a, b)
        else:
            scale = max(float(np.abs(b).max()), 1e-6)
            np.testing.assert_allclose(a, b, rtol=0, atol=atol_of_scale * scale, err_msg=name)


# ---------------------------------------------------------------------------
# fused_sweep_sphere
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("occlusion", [0, 2])
@pytest.mark.parametrize("two_pass", [False, True])
def test_windowed_sweep_matches_jax_kernel_branch(interpret_kernel, two_pass, occlusion):
    """Windowed branch (plain gather) vs JAX's kernel branch in interpret mode
    at 32x128, as tests/test_warp_kernel_interpret.py:321 does. The gathers
    are bit-identical, so term counts are exact; the sums differ only by
    reduction order (torch's vs XLA's f32 sums over ~4k terms): 1e-5 of
    the matrix scale."""
    level = _random_level(31)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.01, -0.02, 0.03)
    got, want = _sweep_pair(level, pose, windowed=True, occlusion=occlusion, two_pass=two_pass)
    _assert_state_close(got, want, 1e-5)
    assert int(got[5]) > 1000  # the scene contributes terms


@pytest.mark.parametrize("occlusion,stats_only", [(0, False), (1, False), (2, False), (0, True)])
def test_exact_sweep_matches_jax_xla_branch(occlusion, stats_only):
    """Exact branch vs JAX's XLA branch. JAX packs the gradients as f16 pairs
    on that branch and the port keeps f32, so entries agree to 2e-3 of the
    matrix scale (the bound tests/test_warp_kernel_interpret.py:376 uses for
    the same two layouts); the gradients here are far above the saliency
    threshold, so counts are exact."""
    level = _random_level(37)
    pose = np.asarray(golden_ref.pseudo_exp(np.array([0.05, -0.03, 0.04, 0.01, -0.02, 0.015])), np.float32)
    got, want = _sweep_pair(level, pose, windowed=False, occlusion=occlusion, stats_only=stats_only)
    _assert_state_close(got, want, 2e-3)
    if stats_only:
        assert not got[1].any() and not got[2].any()


def test_exact_final_missed_stats_matches_jax(interpret_kernel):
    """The exact-final miss re-gather (window mask + dual-anchored pass) at a
    large motion, against JAX with its kernel in interpret mode."""
    level = _random_level(23)
    h, w = level.gray_src.shape
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.25, -0.4, 0.55)
    lj = jp.LevelData(*[jnp.asarray(f) for f in level])
    xyz, valid = j_lut(lj.depth_src, jp.MIN_DEPTH, jp.MAX_DEPTH)
    want = [np.asarray(x) for x in jp._exact_final_missed_stats(
        lj.gray_src.reshape(-1), jp.pack_target_planes8(lj), (h, w), xyz, valid, jnp.asarray(pose), jp.PHOTO_DEPTH
    )]
    lt = convert.level_from_numpy(level, "cpu")
    xyz_t, valid_t = t_lut(lt.depth_src, tp.MIN_DEPTH, tp.MAX_DEPTH)
    got = [x[0].numpy() for x in tp._exact_final_missed_stats(
        lt.gray_src.reshape(1, -1), tp.pack_target_planes8(lt), (h, w), xyz_t, valid_t,
        convert.pose_from_numpy(pose, "cpu"), tp.PHOTO_DEPTH,
    )]
    assert want[4] > 0  # the scene exercises the re-gather
    for a, b, name in zip(got, want, ["photo_err2", "n_photo", "depth_err2", "n_depth", "n_extra"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=name)  # sums: reduction order only


# ---------------------------------------------------------------------------
# the golden gates (tests/test_golden_parity.py, on the port)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _golden_images(golden):
    return (
        golden["gray_src_u8"].astype(np.float32) / 255.0,
        golden["depth_src_mm"].astype(np.float32) * 0.001,
        golden["gray_trg_u8"].astype(np.float32) / 255.0,
        golden["depth_trg_mm"].astype(np.float32) * 0.001,
    )


# JAX's f32-gradient sweep (separate f32 images, no f16 packing), jitted
_jax_f32_sweep = jax.jit(lambda level, xyz, valid, pose: jp.hess_grad_sphere(level, xyz, valid, pose, jp.PHOTO_DEPTH))


def _jax_golden_pyramids(golden):
    gs, ds, gt, dt = [jnp.asarray(x) for x in _golden_images(golden)]
    n = int(golden["n_levels"])
    src = jp.build_pyramid_set(gs, ds, n, is_target=False, sphere_seam_mask=True)
    trg = jp.build_pyramid_set(gt, dt, n, is_target=True, sphere_seam_mask=True)
    return src, trg


@pytest.fixture(scope="module")
def port_pyramids(golden):
    gs, ds, gt, dt = [_t(x)[None] for x in _golden_images(golden)]
    n = int(golden["n_levels"])
    src = tp.build_pyramid_set(gs, ds, n, is_target=False, sphere_seam_mask=True)
    trg = tp.build_pyramid_set(gt, dt, n, is_target=True, sphere_seam_mask=True)
    return src, trg


def _port_sweep_at(src, trg, level_idx, pose):
    level = tp.make_level_data(src, trg, level_idx)
    xyz, valid = t_lut(level.depth_src, 0.3, 6.0)
    return tp.fused_sweep_sphere(
        level.gray_src.reshape(1, -1), tp.pack_target_planes8(level), tuple(level.gray_src.shape[-2:]),
        xyz, valid, convert.pose_from_numpy(pose, "cpu"), tp.PHOTO_DEPTH,
    )


def test_per_level_residuals_vs_golden(golden, port_pyramids):
    """Residual/H/g/SSO/counts at the golden incoming pose of every level,
    with test_golden_parity.py's tolerances, and the term counts within 4
    of the JAX package's own f32 sweep (hess_grad_sphere) at every level.

    One count differs: at L0 the f64 golden has 38567 depth terms and the
    f32 sweeps of both packages 38446. The L0 depths are whole millimetres,
    so many depth gradients equal the 0.01 saliency threshold exactly in
    real arithmetic, and f32 and f64 round them to opposite sides. The
    50-term bound of test_golden_parity.py was set on JAX's f16-packed
    gradients, which round 0.01 up; against f32 gradients the L0 depth count
    is held within 125 of the golden (measured 121, 0.31%)."""
    src, trg = port_pyramids
    src_j, trg_j = _jax_golden_pyramids(golden)
    n = int(golden["n_levels"])
    for k, lv in enumerate(range(n - 1, -1, -1)):
        pose = golden["free_level_pose_in"][k]
        err, H, g, sso, _pe2, n_photo, _de2, n_depth = [x[0].numpy() for x in _port_sweep_at(src, trg, lv, pose)]
        level_j = jp.make_level_data(src_j, trg_j, lv)
        xyz_j, valid_j = j_lut(level_j.depth_src, 0.3, 6.0)
        f32_sweep = _jax_f32_sweep(level_j, xyz_j, valid_j, jnp.asarray(pose, jnp.float32))
        # a count may flip where a projected index sits on a rounding
        # boundary (jit fuses the projection differently: measured 1 term)
        assert abs(int(n_photo) - int(f32_sweep[4])) <= 4, f"level {lv} photo count"
        assert abs(int(n_depth) - int(f32_sweep[6])) <= 4, f"level {lv} depth count"
        err_g = golden["free_level_err_in"][k]
        assert abs(float(err) - err_g) / err_g < 5e-4, f"level {lv} error drift"
        H_g, g_g = golden["free_level_H_in"][k], golden["free_level_g_in"][k]
        np.testing.assert_allclose(H / np.abs(H_g).max(), H_g / np.abs(H_g).max(), atol=5e-4)
        np.testing.assert_allclose(g / np.abs(g_g).max(), g_g / np.abs(g_g).max(), atol=5e-3)
        assert abs(float(sso) - golden["free_level_sso_in"][k]) < 1e-3
        assert abs(int(n_photo) - int(golden["free_level_n_photo_in"][k])) <= 50
        assert abs(int(n_depth) - int(golden["free_level_n_depth_in"][k])) <= (125 if lv == 0 else 50)


def test_forced_schedule_pose_below_1e3(golden, port_pyramids):
    """forced_iters unconditionally accepted GN steps per level; the pose
    chain composes on the host in f64, as test_golden_parity.py does."""
    src, trg = port_pyramids
    n, k = int(golden["n_levels"]), int(golden["forced_iters"])
    pose = np.eye(4)
    for lv in range(n - 1, -1, -1):
        for _ in range(k):
            _err, H, g, *_ = _port_sweep_at(src, trg, lv, pose)
            x, ok = t_linalg6.solve6_sym(H, g)
            assert bool(ok[0])
            pose = golden_ref.pseudo_exp(-x[0].numpy().astype(np.float64)) @ pose
    diff = np.abs(pose - golden["forced_pose"]).max()
    assert diff < 1e-3, f"forced-schedule pose drift {diff:.2e}"


def _in_golden_basin(pose, golden):
    t_gold = np.linalg.norm(golden["free_pose"][:3, 3])
    t_diff = abs(np.linalg.norm(pose[:3, 3]) - t_gold)
    rot = float(t_se3.rot_angle_deg(_t(pose[:3, :3].astype(np.float32)), _t(golden["free_pose"][:3, :3].astype(np.float32))))
    return t_diff < 0.06 and rot < 2.0, (t_diff, rot)


@pytest.fixture(scope="module")
def port_free_run(golden, port_pyramids):
    src, trg = port_pyramids
    return tp.align_frames360(src, trg, torch.eye(4)[None], tp.PHOTO_DEPTH)


def test_free_run_lands_in_golden_basin(golden, port_free_run):
    res = port_free_run
    assert not bool(res.ill_posed[0])
    ok, detail = _in_golden_basin(res.pose[0].numpy(), golden)
    assert ok, detail
    assert abs(float(res.error[0]) - float(golden["free_error"])) < 0.15


def test_jax_pyramids_through_convert_give_the_same_align(golden, port_free_run):
    """JAX-built pyramids, carried over by convert.py, drive the port's
    aligner to the same result bit for bit: the pyramids agree exactly, so
    any aligner drift would show here apart from image-op drift."""
    src_j, trg_j = _jax_golden_pyramids(golden)
    as_np = lambda pyrs: tuple([np.asarray(lv) for lv in part] for part in pyrs)
    src, trg = convert.pyramids_from_numpy(as_np(src_j), as_np(trg_j), "cpu")
    assert src[0][0].shape == (1, 320, 1920) and len(trg) == 6
    res = convert.align_result_to_numpy(
        tp.align_frames360(src, trg, convert.pose_from_numpy(np.eye(4), "cpu"), tp.PHOTO_DEPTH), squeeze=True
    )
    ref = convert.align_result_to_numpy(port_free_run, squeeze=True)
    assert res["pose"].shape == (4, 4) and res["num_iterations"].shape == (5,)
    for name in ref:
        np.testing.assert_array_equal(res[name], ref[name], err_msg=name)


# ---------------------------------------------------------------------------
# align_batch and the batched loop
# ---------------------------------------------------------------------------


def test_align_batch_matches_jax_align_batch(golden):
    """B=2 on the golden pair, the port against JAX's align_batch, both on
    the CPU: both in the golden basin, both errors within 0.15 of the golden
    free run, both iteration signatures CPU-cross-checked (bench.py)."""
    imgs = [np.broadcast_to(x, (2,) + x.shape).copy() for x in _golden_images(golden)]
    res_j = j_align_batch(*[jnp.asarray(x) for x in imgs], jnp.broadcast_to(jnp.eye(4), (2, 4, 4)))
    res_t = t_align_batch(*[_t(x) for x in imgs], torch.eye(4).expand(2, 4, 4).contiguous())
    for i in range(2):
        for pose, err, sig in (
            (np.asarray(res_j.pose[i]), float(res_j.error[i]), np.asarray(res_j.num_iterations[i])),
            (res_t.pose[i].numpy(), float(res_t.error[i]), res_t.num_iterations[i].numpy()),
        ):
            ok, detail = _in_golden_basin(pose, golden)
            assert ok, detail
            assert abs(err - float(golden["free_error"])) < 0.15
            assert tuple(int(s) for s in sig) in bench.FALLBACK_SIGNATURES
    assert not res_t.ill_posed.any() and res_t.num_iterations.dtype == torch.int32
    assert res_t.pose.shape == (2, 4, 4) and res_t.hessian.shape == (2, 6, 6) and res_t.error.shape == (2,)


def _half_res_pyramids(golden, pairs):
    """4-level pyramids of 960x160 panoramas (the golden pair reduced once)
    for the listed (src, trg) image choices, stacked on the pair axis."""
    gs, ds, gt, dt = [_t(x) for x in _golden_images(golden)]
    half = lambda g, d: (t_image.pyr_down(g), t_image.depth_down_valid(d, 0.3, 6.0))
    (gs, ds), (gt, dt) = half(gs, ds), half(gt, dt)
    imgs = {"src": (gs, ds), "trg": (gt, dt), "nodepth": (gs, torch.zeros_like(ds))}
    s = [torch.stack([imgs[a][k] for a, _ in pairs]) for k in (0, 1)]
    t = [torch.stack([imgs[b][k] for _, b in pairs]) for k in (0, 1)]
    src = tp.build_pyramid_set(s[0], s[1], 4, is_target=False, sphere_seam_mask=True)
    trg = tp.build_pyramid_set(t[0], t[1], 4, is_target=True, sphere_seam_mask=True)
    return src, trg


def test_batched_loop_freezes_each_pair_like_vmap_of_while(golden):
    """Three pairs with different fates in one batch: a real pair (runs the
    full schedule), a self-pair (no step improves it) and a source without
    depth (no term, error 0: its loop never starts). Each pair's result
    equals its own B=1 run: a finished pair's state is frozen while the
    others iterate, as JAX's vmap of lax.while_loop does. Iterations and
    flags agree exactly; the pose to 1e-4, because torch sums a (3, N) and
    a (1, N) batch in different orders and the accept/reject chain
    amplifies last-ulp differences of the sums (the stopping-point
    sensitivity tests/test_golden_parity.py notes)."""
    pairs = [("src", "trg"), ("trg", "trg"), ("nodepth", "trg")]
    src, trg = _half_res_pyramids(golden, pairs)
    batched = tp.align_frames360(src, trg, torch.eye(4).expand(3, 4, 4).contiguous(), tp.PHOTO_DEPTH)
    for i, pair in enumerate(pairs):
        s1, t1 = _half_res_pyramids(golden, [pair])
        solo = tp.align_frames360(s1, t1, torch.eye(4)[None], tp.PHOTO_DEPTH)
        np.testing.assert_array_equal(batched.num_iterations[i].numpy(), solo.num_iterations[0].numpy())
        assert bool(batched.ill_posed[i]) == bool(solo.ill_posed[0])
        np.testing.assert_allclose(batched.pose[i].numpy(), solo.pose[0].numpy(), atol=1e-4)
        np.testing.assert_allclose(float(batched.error[i]), float(solo.error[0]), rtol=1e-4)
    assert batched.num_iterations[0].sum() > 10  # the real pair iterates
    np.testing.assert_array_equal(batched.num_iterations[1:].numpy(), 0)
    assert not bool(batched.ill_posed.any()) and float(batched.error[2]) == 0.0
    np.testing.assert_array_equal(batched.pose[2].numpy(), np.eye(4, dtype=np.float32))


def test_ill_posed_pair_freezes_alone(golden, monkeypatch):
    """A pair whose system is ill-posed (here: its observability check is
    made to fail) stops at once and keeps its pose through every finer
    level (photoicp.py:890-895), while the healthy pair beside it runs as
    if alone."""
    src, trg = _half_res_pyramids(golden, [("src", "trg"), ("src", "trg")])
    solo = tp.align_frames360(*_half_res_pyramids(golden, [("src", "trg")]), torch.eye(4)[None], tp.PHOTO_DEPTH)
    real = tp.linalg6.spd_well_posed
    monkeypatch.setattr(tp.linalg6, "spd_well_posed", lambda H, lam: real(H, lam) & torch.tensor([True, False]))
    res = tp.align_frames360(src, trg, torch.eye(4).expand(2, 4, 4).contiguous(), tp.PHOTO_DEPTH)
    assert res.ill_posed.tolist() == [False, True]
    np.testing.assert_array_equal(res.num_iterations[1].numpy(), 0)
    np.testing.assert_array_equal(res.pose[1].numpy(), np.eye(4, dtype=np.float32))
    assert math.isfinite(float(res.error[1]))  # the finer levels still sweep for stats
    np.testing.assert_array_equal(res.num_iterations[0].numpy(), solo.num_iterations[0].numpy())
    np.testing.assert_allclose(res.pose[0].numpy(), solo.pose[0].numpy(), atol=1e-4)


def test_full_coverage_windowed_route_agrees_with_exact_route(golden, windowed_route):
    """full_coverage runs the triple-anchored gather in every sweep of the
    windowed levels (loop-closure refinement, relocalization): at half
    resolution it lands where the exact route lands."""
    src, trg = _half_res_pyramids(golden, [("src", "trg")])
    tp.reset_sweep_counts()
    res_w = tp.align_frames360(src, trg, torch.eye(4)[None], tp.PHOTO_DEPTH, full_coverage=True)
    assert tp.SWEEPS["full_coverage"] > 0 and tp.SWEEPS["windowed"] == tp.SWEEPS["exact_final_dual"] == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tp, "_use_warp_kernel", lambda shape, device: False)
        res_e = tp.align_frames360(src, trg, torch.eye(4)[None], tp.PHOTO_DEPTH)
    dt = np.linalg.norm(res_w.pose[0, :3, 3].numpy() - res_e.pose[0, :3, 3].numpy())
    rot = float(t_se3.rot_angle_deg(res_w.pose[0, :3, :3], res_e.pose[0, :3, :3]))
    assert dt < 0.06 and rot < 2.0, (dt, rot)
    assert math.isfinite(float(res_w.error[0])) and not bool(res_w.ill_posed[0])


@pytest.fixture()
def single_buffer(interpret_kernel, monkeypatch):
    """Both packages' warp_gather_batched on the single-buffer ``_kernel``;
    JAX reads the flag at trace time, hence the cleared jit cache."""
    monkeypatch.setattr(jw, "PIPELINE_KERNEL", False)
    monkeypatch.setattr(tw, "PIPELINE_KERNEL", False)
    jw.warp_gather_batched.clear_cache()
    yield
    jw.warp_gather_batched.clear_cache()


@pytest.mark.parametrize("level_idx", [0, 1, 2])
def test_single_buffer_sweep_matches_jax_at_golden_poses(golden, single_buffer, level_idx):
    """The windowed sweep of the levels the kernel serves (L0-L2 of the
    golden pair, at the golden incoming pose of the level) on the
    single-buffer route: the port (plain ``_kernel``) against JAX's kernel
    branch with ``_kernel`` in interpret mode, to the tolerances of
    test_windowed_sweep_matches_jax_kernel_branch (bit-identical gathers:
    exact counts; sums to 1e-5 of the matrix scale)."""
    src_j, trg_j = _jax_golden_pyramids(golden)
    pose = golden["free_level_pose_in"][int(golden["n_levels"]) - 1 - level_idx].astype(np.float32)
    level_np = jp.LevelData(*[np.asarray(x) for x in jp.make_level_data(src_j, trg_j, level_idx)])
    got, want = _sweep_pair(level_np, pose, windowed=True)
    _assert_state_close(got, want, 1e-5)
    assert int(got[5]) > 1000


def test_single_buffer_route_full_resolution_passes_kernel_path_rails(golden, windowed_route, monkeypatch):
    """The golden pair at 1920x320, 5 levels, PHOTO_DEPTH on the
    single-buffer route (L0-L2 sweeps through the plain ``_kernel``, the
    exact-final still dual-anchored). Measured on the CPU: signature
    (0, 7, 10, 10, 10), finest error 2.393919, |t| 0.312743 m, so it is held
    to the default route's rails (bench.sanity_check(kernel_path=True))."""
    monkeypatch.setattr(tw, "PIPELINE_KERNEL", False)
    imgs = [_t(x)[None] for x in _golden_images(golden)]
    tp.reset_sweep_counts()
    res = t_align_batch(*imgs, torch.eye(4)[None])
    ok, reasons = bench.sanity_check(
        res.pose[0].numpy(), float(res.error[0]), bool(res.ill_posed[0]), res.num_iterations[0].numpy(),
        golden=golden, kernel_path=True,
    )
    assert ok, reasons
    assert tuple(res.num_iterations[0].tolist()) == (0, 7, 10, 10, 10)
    assert abs(float(res.error[0]) - 2.393919) < 0.05
    assert tp.SWEEPS == {"windowed": 33, "full_coverage": 0, "exact": 11, "exact_final_dual": 1}


def test_windowed_route_full_resolution_passes_kernel_path_rails(golden, windowed_route):
    """The CPU preview of the card's main path: the golden pair at 1920x320,
    5 levels, PHOTO_DEPTH, with L0-L2 through the windowed gather (plain
    version here) and the dual-anchored exact-final, held to the bench's
    kernel-path rails: golden basin, two-sided error band, and the full
    iteration signature (0, 7, 10, 10, 10)."""
    imgs = [_t(x)[None] for x in _golden_images(golden)]
    tp.reset_sweep_counts()
    res = t_align_batch(*imgs, torch.eye(4)[None])
    ok, reasons = bench.sanity_check(
        res.pose[0].numpy(), float(res.error[0]), bool(res.ill_posed[0]), res.num_iterations[0].numpy(),
        golden=golden, kernel_path=True,
    )
    assert ok, reasons
    # L0-L2 sweep windowed: 10 accepted steps + the initial sweep each; the
    # coarse levels sweep exactly; one dual pass for the exact-final stats
    assert tp.SWEEPS == {"windowed": 33, "full_coverage": 0, "exact": 11, "exact_final_dual": 1}
