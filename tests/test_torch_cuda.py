"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one. The file
imports no jax, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the suite.)
Its warp-gather scenes are shared with the CPU parity tests against the
Pallas kernel (tests/test_torch_warp_gather.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rgbd360_torch.ops import warp_gather as tw  # noqa: E402

VARIANTS = ["mean", "min", "max", "dual", "full"]
ANCHORS = {"dual": tw.DUAL, "full": tw.FULL}
SCENES = ["identity", "seam_yaw", "two_band", "empty_tiles", "denormals"]


def planes_like(rng, b, h, w):
    planes = rng.normal(size=(b, h, 8, w)).astype(np.float32)
    planes[:, :, 6] = 0.0
    planes[:, :, 7] = 0.0
    return planes


def scene(name):
    """(planes (B,H,8,W) f32, r, c (B,H,W) i32, active (B,H,W) bool or None)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    b, h, w = 2, 32, 256
    yy, xx = np.mgrid[0:h, 0:w]
    planes = planes_like(rng, b, h, w)
    active = None
    if name == "identity":
        r = np.broadcast_to(yy, (b, h, w))
        c = np.broadcast_to(xx, (b, h, w))
    elif name == "seam_yaw":
        # a rigid yaw per pair: whole tiles' targets straddle the theta seam
        shift = np.array([100, -37])[:, None, None]
        r = np.clip(yy[None] + rng.integers(-1, 2, (b, h, w)), 0, h - 1)
        c = (xx[None] + shift + rng.integers(-3, 4, (b, h, w))) % w
    elif name == "two_band":
        # two parallax bands 20 rows apart: no K = 4 row window spans both
        band = np.where((xx % 2) == 0, -10, 10)
        r = np.clip(yy[None] + band[None] * np.array([1, -1])[:, None, None], 0, h - 1)
        c = (xx[None] + rng.integers(-5, 6, (b, h, w))) % w
    elif name == "empty_tiles":
        r = np.clip(yy[None] + rng.integers(-6, 7, (b, h, w)), 0, h - 1)
        c = (xx[None] + rng.integers(-20, 21, (b, h, w))) % w
        active = rng.random((b, h, w)) < 0.3  # sparse, like a miss set
        active[0, 0:8, 0:128] = False  # whole (8, 128) tiles with no pixel
        active[1, 8:24, 128:256] = False
    elif name == "denormals":
        # f32 denormals, -0.0 and a raw bit pattern in the data channels,
        # gathered through a near-identity warp that covers nearly all
        planes[:, ::3, 2, ::5] = np.float32(1e-42)
        planes[:, 1::3, 3, ::4] = np.frombuffer(np.int32(7).tobytes(), np.float32)[0]
        planes[:, :, 4, 1::3] = np.float32(-0.0)
        planes[:, 2::5, 5] = -np.abs(planes[:, 2::5, 5]) * np.float32(0.0)  # -0.0 as the seam mask makes it
        r = np.clip(yy[None] + rng.integers(-1, 2, (b, h, w)), 0, h - 1)
        c = (xx[None] + rng.integers(-10, 11, (b, h, w))) % w
    else:
        raise KeyError(name)
    return planes, np.ascontiguousarray(r, np.int32), np.ascontiguousarray(c, np.int32), active


def wide_scene():
    """A 960-wide wrap level, the width of L1 (not a multiple of 128, above
    2*PC): pair 0 drives remapped targets into the widened halo, pair 1 is
    a rigid yaw across the seam."""
    rng = np.random.default_rng(960)
    b, h, w = 2, 16, 960
    yy, xx = np.mgrid[0:h, 0:w]
    planes = planes_like(rng, b, h, w)
    c0 = np.where((xx % 2) == 0, 64 + (xx // 2) % 64, 900 + xx % 60)
    c1 = (xx + 700 + rng.integers(-4, 5, (h, w))) % w
    r = np.clip(yy[None] + rng.integers(-2, 3, (b, h, w)), 0, h - 1)
    return planes, r.astype(np.int32), np.stack([c0, c1]).astype(np.int32), None


def run_port(planes, r, c, active, variant, device="cpu", plain=False):
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(device)
    P, R, C, A = t(planes), t(r), t(c), t(active)
    if variant in ANCHORS:
        if A is None:
            A = torch.ones(R.shape, dtype=torch.bool, device=device)
        fn = tw.warp_gather_batched_multi_plain if plain else tw.warp_gather_batched_multi
        out, mask = fn(P, R, C, A, anchors=ANCHORS[variant])
    else:
        fn = tw.warp_gather_batched_plain if plain else tw.warp_gather_batched
        out, mask = fn(P, R, C, A, row_policy=variant)
    return out.cpu().numpy(), mask.cpu().numpy()


def run_single(planes, r, c, device="cpu", plain=False):
    """The single-buffer pass (the Pallas ``_kernel``) on numpy operands."""
    fn = tw.warp_gather_single_plain if plain else tw.warp_gather_single
    out, mask = fn(*(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (planes, r, c)))
    return out.cpu().numpy(), mask.cpu().numpy()


def assert_bit_exact(got, want):
    (out_t, mask_t), (out_j, mask_j) = got, want
    assert out_t.shape == out_j.shape and out_t.dtype == np.float32
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(out_t.view(np.int32), out_j.view(np.int32))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
def test_warp_gather_kernel_bit_exact_vs_plain(cuda, variant):
    counter = "warp_gather_batched_multi" if variant in ANCHORS else "warp_gather_batched"
    for name in SCENES + ["wide"]:
        planes, r, c, active = wide_scene() if name == "wide" else scene(name)
        before = tw.LAUNCHES[counter]
        got = run_port(planes, r, c, active, variant, device=cuda)
        torch.cuda.synchronize()
        assert tw.LAUNCHES[counter] == before + 1
        assert_bit_exact(got, run_port(planes, r, c, active, variant, device=cuda, plain=True))


@pytest.mark.cuda
def test_warp_gather_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    planes, r, c, _active = scene("identity")
    P, R, C = (torch.from_numpy(x).to(cuda) for x in (planes, r, c))
    with pytest.raises(ValueError):
        tw.warp_gather_batched(P, R.transpose(1, 2).contiguous().transpose(1, 2), C)  # not contiguous
    with pytest.raises(ValueError):
        tw.warp_gather_batched(P, R.cpu(), C)  # two devices


@pytest.mark.cuda
def test_single_buffer_kernel_bit_exact_vs_plain(cuda, monkeypatch):
    """The kSingle mode of csrc/warp_gather.cu (the Pallas ``_kernel``)
    against its plain version, directly and through warp_gather_batched
    under PIPELINE_KERNEL = False (which ignores row policy and active)."""
    for name in SCENES + ["wide"]:
        planes, r, c, active = wide_scene() if name == "wide" else scene(name)
        before = tw.LAUNCHES["warp_gather_single"]
        got = run_single(planes, r, c, device=cuda)
        torch.cuda.synchronize()
        assert tw.LAUNCHES["warp_gather_single"] == before + 1
        assert_bit_exact(got, run_single(planes, r, c, device=cuda, plain=True))
        monkeypatch.setattr(tw, "PIPELINE_KERNEL", False)
        routed = run_port(planes, r, c, active, "min", device=cuda)
        monkeypatch.setattr(tw, "PIPELINE_KERNEL", True)
        assert tw.LAUNCHES["warp_gather_single"] == before + 2
        assert_bit_exact(routed, got)


@pytest.mark.cuda
def test_plane_bin_sums_on_the_card_equal_the_cpu_run_after_run(cuda):
    """The plane layer's per-label sums (ops/planes_seg.py::_bin_sum) add in
    index order on the card too: bit-equal to the CPU's, every run."""
    from rgbd360_torch.ops.planes_seg import _bin_sum

    rng = np.random.default_rng(5)
    bins = torch.from_numpy(rng.integers(0, 65, (8, 19200)))
    vals = torch.from_numpy((rng.normal(size=(8, 19200, 4)) * 3).astype(np.float32))
    want = _bin_sum(bins, vals, 65)
    for _ in range(3):
        assert torch.equal(_bin_sum(bins.to(cuda), vals.to(cuda), 65).cpu(), want)


@pytest.mark.cuda
def test_plane_stats_buffer_reaches_the_host_through_the_event(cuda):
    """plane_extraction.HostCopy: a non-blocking copy into pinned memory,
    waited on through its CUDA event, from another thread too."""
    import threading

    from rgbd360_torch.core.plane_extraction import HostCopy

    buf = torch.arange(770_000, device=cuda).to(torch.uint8)
    copy = HostCopy(buf)
    assert copy._host.is_pinned()
    got = {}
    th = threading.Thread(target=lambda: got.setdefault("host", copy.result()))
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    np.testing.assert_array_equal(got["host"], buf.cpu().numpy())


@pytest.mark.cuda
def test_batch_match_prefilter_on_the_card_equals_the_cpu(cuda):
    """core/batch_match.py: the compatibility matrices on the card (f32,
    TF32 off) equal the CPU's, and so do the prefilter's counts and areas."""
    from rgbd360_torch.core import batch_match as bm
    from rgbd360_torch.core.matcher import DEFAULT_6DOF, ODOMETRY_6DOF, PLANAR_3DOF, PLANAR_ODOMETRY_3DOF, MatcherConfig
    from rgbd360_torch.core.pbmap import PbMap, Plane, rgb_to_hue_hist

    rng = np.random.default_rng(12)

    def pbmap(n):
        planes = []
        for i in range(n):
            normal = rng.normal(size=3)
            p = Plane(id=i, normal=normal / np.linalg.norm(normal), center=rng.uniform(-3, 3, 3),
                      area_hull=float(rng.uniform(0.3, 9.0)), elongation=float(rng.uniform(1, 4)))
            p.d = float(-p.normal @ p.center)
            p.hist_h = rgb_to_hue_hist(rng.integers(0, 256, (40, 3), dtype=np.uint8))
            planes.append(p)
        return PbMap(planes)

    frame, cands = pbmap(25), [pbmap(n) for n in (4, 25, 60, 12)]
    cfg = MatcherConfig()
    for mode in (DEFAULT_6DOF, PLANAR_3DOF, ODOMETRY_6DOF, PLANAR_ODOMETRY_3DOF):
        packs = [bm.pack_pbmap(c) for c in cands]
        on_card = bm.compat_matrices(*bm.upload_packs(bm.pack_pbmap(frame), packs, cuda), bm.config_tuple(cfg), mode)
        on_cpu = bm.compat_matrices(*bm.upload_packs(bm.pack_pbmap(frame), packs, "cpu"), bm.config_tuple(cfg), mode)
        assert on_card.device.type == "cuda" and torch.equal(on_card.cpu(), on_cpu)
        counts_g, areas_g = bm.prefilter_candidates(frame, cands, cfg, mode, device=cuda)
        counts_c, areas_c = bm.prefilter_candidates(frame, cands, cfg, mode, device="cpu")
        np.testing.assert_array_equal(counts_g, counts_c)
        np.testing.assert_array_equal(areas_g, areas_c)


@pytest.mark.cuda
def test_full_coverage_align_batch_launches_equal_its_sweeps(cuda):
    """align_batch(full_coverage=True) at B=2 (the loop closer's batched
    refinement) on the golden pair: every windowed sweep launches the FULL
    form of the kernel, once, and nothing else launches."""
    import os

    from rgbd360_torch.ops import photoicp
    from rgbd360_torch.parallel.batch import align_batch

    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "pair_1_10.npz"))
    img = lambda key, scale: torch.from_numpy(
        np.stack([golden[key].astype(np.float32) * scale] * 2)).to(cuda)
    tw.reset_launch_counts()
    photoicp.reset_sweep_counts()
    res = align_batch(img("gray_src_u8", 1 / 255.0), img("depth_src_mm", 0.001), img("gray_trg_u8", 1 / 255.0),
                      img("depth_trg_mm", 0.001), torch.eye(4, device=cuda).expand(2, 4, 4).contiguous(),
                      photoicp.PHOTO_DEPTH, 5, full_coverage=True)
    torch.cuda.synchronize()
    assert photoicp.SWEEPS["full_coverage"] > 0
    assert tw.LAUNCHES["warp_gather_batched_multi"] == photoicp.SWEEPS["full_coverage"]
    assert tw.LAUNCHES["warp_gather_batched"] == tw.LAUNCHES["warp_gather_single"] == 0
    assert photoicp.SWEEPS["windowed"] == photoicp.SWEEPS["exact_final_dual"] == 0
    assert torch.isfinite(res.pose).all() and not bool(res.ill_posed.any())
    assert float((res.pose[0] - res.pose[1]).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_pinhole_robot_sweep_occ1_on_the_card_matches_the_cpu(cuda):
    """ops/photoicp_pinhole.py's fused sweep in the robot frame with the
    z-buffer (Occ1), 8 x 240 x 320 (the 8-camera registration's L0), on the
    card against the same call on the CPU: the term counts within 1e-4 of
    their total (a round-half or z-buffer tie that f32 contraction moves),
    the sums within 1e-4 relative, H and g within 1e-4 of their scale (the
    order of f32 sums over 614k terms)."""
    from rgbd360_torch.core.calibrator import construction_specs
    from rgbd360_torch.io.calib import qvga_camera_matrix
    from rgbd360_torch.ops import photoicp
    from rgbd360_torch.ops import photoicp_pinhole as pp
    from rgbd360_torch.ops.image import gray_f32
    from tools import synthetic_rig as rig

    rts = construction_specs().astype(np.float32)
    p_src, p_trg = rig.loop_pose(0.1, 0.8), rig.loop_pose(0.0, 0.8)
    src, trg = rig.room_capture(p_src, rts), rig.room_capture(p_trg, rts)
    pose = (np.linalg.inv(p_trg) @ p_src).astype(np.float32)

    def sweep(dev):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        level = photoicp.make_level_data(
            photoicp.build_pyramid_set(gray_f32(t(src.rgb)), t(src.depth).to(torch.float32) * 0.001, 1,
                                       is_target=False, sphere_seam_mask=False),
            photoicp.build_pyramid_set(gray_f32(t(trg.rgb)), t(trg.depth).to(torch.float32) * 0.001, 1,
                                       is_target=True, sphere_seam_mask=False), 0)
        k = t(qvga_camera_matrix())
        xyz, valid = pp.pinhole_lut(level.depth_src, k, 0)
        out = pp.fused_sweep_pinhole(level.gray_src.reshape(8, -1), photoicp.pack_target_planes8(level), (240, 320),
                                     xyz, valid, t(pose), k, 0, pp.PHOTO_DEPTH, t(rts), occlusion=1)
        return [x.cpu().numpy() for x in out]

    on_card, on_cpu = sweep(cuda), sweep("cpu")
    err2_g, n_g, H_g, g_g, _pe, np_g, _de, nd_g = on_card
    err2_c, n_c, H_c, g_c, _pe, np_c, _de, nd_c = on_cpu
    assert int(n_c) > 400_000
    for a, b in ((n_g, n_c), (np_g, np_c), (nd_g, nd_c)):
        assert abs(int(a) - int(b)) <= 1e-4 * int(n_c)
    assert float(err2_g) == pytest.approx(float(err2_c), rel=1e-4)
    np.testing.assert_allclose(H_g, H_c, rtol=0, atol=1e-4 * np.abs(H_c).max())
    np.testing.assert_allclose(g_g, g_c, rtol=0, atol=1e-4 * np.abs(g_c).max())


@pytest.mark.cuda
def test_stereo_program_on_the_card_matches_the_cpu(cuda, tmp_path):
    """core/frame360_stereo.py's getPlanesStereo at the full 1024 x 180 on
    the room ray-cast in the stereo convention (the refinement's full-bin
    branch: 184k bins summed by index_put_(accumulate=True)), on the card
    against the CPU by chip_smoke.stereo_parity's gates: segment-stage
    labels equal, refined labels within 0.15% with each pixel explained,
    the same planes (normals 1e-4, d 1 mm)."""
    from PIL import Image

    import chip_smoke
    from rgbd360_torch.core.frame360_stereo import write_stereo_depth
    from tools import synthetic_rig as rig

    rgb, depth = rig.raycast_room_stereo(rig.stereo_pose())
    png, depth_bin = str(tmp_path / "stereo.png"), str(tmp_path / "stereo.bin")
    Image.fromarray(np.ascontiguousarray(rgb[..., ::-1])).save(png)
    write_stereo_depth(depth_bin, depth)
    out = chip_smoke.stereo_parity(cuda, png, depth_bin)
    assert out["planes"][0] >= 6


@pytest.mark.cuda
def test_split_on_one_card_is_bit_equal_to_align_batch(cuda):
    """parallel/mesh.py over [cuda:0, cuda:0] (two shards of 4 pairs, each
    in its own thread on its own stream) at 160 x 960, where both levels of
    a 2-level pyramid take the kernel: every AlignResult field equal to
    align_batch's over the 8 pairs, and the launches counted across both
    threads equal to the windowed sweeps."""
    from rgbd360_torch.ops import photoicp
    from rgbd360_torch.parallel import dryrun
    from rgbd360_torch.parallel import mesh as pmesh
    from rgbd360_torch.parallel.batch import align_batch

    gray, depth = (x.to(cuda) for x in dryrun.synthetic_pair(160, 960, 8))
    seeds = dryrun.yawed_seeds(8).to(cuda)
    tw.reset_launch_counts()
    photoicp.reset_sweep_counts()
    split = pmesh.align_batch_sharded([cuda, cuda], gray, depth, gray, depth, seeds, n_levels=2)
    torch.cuda.synchronize()
    assert photoicp.SWEEPS["windowed"] > 0
    assert tw.LAUNCHES["warp_gather_batched"] == photoicp.SWEEPS["windowed"]
    assert tw.LAUNCHES["warp_gather_batched_multi"] == photoicp.SWEEPS["exact_final_dual"] == 2
    dryrun.assert_same_result(split, align_batch(gray, depth, gray, depth, seeds, n_levels=2), "[cuda:0, cuda:0]")


@pytest.mark.cuda
def test_launch_from_a_thread_whose_current_device_is_another_card(cuda):
    """The kernel launches on its tensors' card whatever the calling
    thread's current device is (ops/warp_gather.py::_launch)."""
    import threading

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    planes, r, c, active = scene("seam_yaw")
    want = run_port(planes, r, c, active, "mean", device="cuda:1", plain=True)
    got = {}

    def launch():
        torch.cuda.set_device(0)
        got["out"] = run_port(planes, r, c, active, "mean", device="cuda:1")
        torch.cuda.synchronize(1)

    t = threading.Thread(target=launch)
    t.start()
    t.join()
    assert_bit_exact(got["out"], want)


@pytest.mark.cuda
@pytest.mark.parametrize("full_coverage", [False, True])
def test_every_host_sync_of_the_aligner_is_counted(cuda, full_coverage):
    """Under torch.cuda.set_sync_debug_mode("warn"), one align_batch of the
    golden pair at batch 8 (track-b8's size) warns once per host sync: the
    warnings raised inside align_frames360 equal photoicp.GN's "syncs"
    count of the call, and every other one the call raises comes from the
    pyramid builds. (The first set_sync_debug_mode of a process warns
    itself; that warning is not the call's.)"""
    import os
    import traceback
    import warnings

    from rgbd360_torch.ops import photoicp
    from rgbd360_torch.parallel.batch import align_batch

    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "pair_1_10.npz"))
    img = lambda key, scale: torch.from_numpy(
        np.stack([golden[key].astype(np.float32) * scale] * 8)).to(cuda)
    args = (img("gray_src_u8", 1 / 255.0), img("depth_src_mm", 0.001), img("gray_trg_u8", 1 / 255.0),
            img("depth_trg_mm", 0.001), torch.eye(4, device=cuda).expand(8, 4, 4).contiguous())
    align_batch(*args, full_coverage=full_coverage)  # warm: the kernel's build, the allocator
    torch.cuda.synchronize()
    where = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            names = [f.name for f in traceback.extract_stack()]
            if "align_batch" in names:
                where.append("align" if "align_frames360" in names else
                             "pyramid" if "build_pyramid_set" in names else "elsewhere")

    photoicp.reset_sweep_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = align_batch(*args, full_coverage=full_coverage)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    gn = dict(photoicp.GN)
    assert gn["iterations"] > 0 and gn["host_ns"] >= gn["wait_ns"] > 0
    assert where.count("align") == gn["syncs"] >= gn["iterations"] + 5
    assert where.count("elsewhere") == 0, where
    assert torch.isfinite(res.pose).all()
