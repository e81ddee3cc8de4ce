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
    count of the call, which is one per loop test, and every other one the
    call raises comes from the pyramid builds. The call is the shapes'
    second: it captures the loop's CUDA graphs and replays them. (The
    first set_sync_debug_mode of a process warns itself; that warning is
    not the call's.)"""
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
    photoicp.GRAPH_CACHE.release()
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
    # one read per loop test: a read per body and the test that ends each
    # of the 5 levels; the loop makes its constants on the device
    assert where.count("align") == gn["syncs"] == gn["iterations"] + 5
    assert where.count("elsewhere") == 0, where
    # the measured call captured the graphs and replayed every body
    assert photoicp.GRAPHS["captures"] > 0 and photoicp.GRAPHS["eager_bodies"] == 0
    assert torch.isfinite(res.pose).all()


def _golden_args(cuda, b, swapped=False):
    """The golden pair stacked b times (source and target swapped, and the
    seeds turned the other way, for other inputs of the same shapes), and
    each pair's seed yawed by 0.01 k rad: (gray_src, depth_src, gray_trg,
    depth_trg, seeds)."""
    import os

    from rgbd360_torch.parallel.dryrun import yawed_seeds

    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "pair_1_10.npz"))
    src, trg = ("gray_src_u8", "depth_src_mm"), ("gray_trg_u8", "depth_trg_mm")
    if swapped:
        src, trg = trg, src
    img = lambda key, scale: torch.from_numpy(np.stack([golden[key].astype(np.float32) * scale] * b)).to(cuda)
    seeds = yawed_seeds(b)
    if swapped:
        seeds = seeds.transpose(-1, -2).contiguous()
    return (img(src[0], 1 / 255.0), img(src[1], 0.001), img(trg[0], 1 / 255.0), img(trg[1], 0.001),
            seeds.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("b,full_coverage,occlusion", [
    (8, False, 0), (8, True, 0), (1, False, 0), (3, True, 0), (1, False, 2), (3, False, 2),
])
def test_graph_path_is_bit_equal_to_the_eager_path(cuda, monkeypatch, b, full_coverage, occlusion):
    """The golden pair at 1920 x 320, 5 levels (L0-L2 windowed, L3-L4
    exact): aligns of the same shapes on inputs A, A, B, A replay the
    loop's CUDA graphs from the second on (the first runs uncaptured, the
    second captures), and each equals the same align run uncaptured,
    forced by the shared predicate (level_graphs.use_cuda_graphs), in every
    AlignResult field, bit for bit, and in its SWEEPS and LAUNCHES; B, on
    other inputs, would show a stale buffer. Every windowed sweep launches
    the kernel once."""
    from rgbd360_torch.ops import level_graphs, photoicp
    from rgbd360_torch.parallel.dryrun import assert_same_result

    inputs = {"A": _golden_args(cuda, b), "B": _golden_args(cuda, b, swapped=True)}

    def align(name):
        tw.reset_launch_counts()
        photoicp.reset_sweep_counts()
        res = photoicp.align_spheres(*inputs[name], occlusion=occlusion, full_coverage=full_coverage)
        torch.cuda.synchronize()
        return res, dict(photoicp.SWEEPS), dict(tw.LAUNCHES), dict(photoicp.GRAPHS), dict(photoicp.GN)

    monkeypatch.setattr(level_graphs, "use_cuda_graphs", lambda device: False)
    uncaptured = {name: align(name) for name in inputs}
    monkeypatch.undo()
    photoicp.GRAPH_CACHE.release()
    for k, name in enumerate("AABA"):
        res, sweeps, launches, graphs, gn = align(name)
        want, want_sweeps, want_launches, want_graphs, _gn = uncaptured[name]
        assert_same_result(res, want, f"call {k} ({name})")
        assert sweeps == want_sweeps and launches == want_launches
        assert launches["warp_gather_batched"] == sweeps["windowed"]
        assert launches["warp_gather_batched_multi"] == sweeps["full_coverage"] + sweeps["exact_final_dual"]
        assert sweeps["windowed" if not full_coverage else "full_coverage"] > 0
        assert gn["iterations"] > 0 and want_graphs["eager_bodies"] == gn["iterations"]
        if k == 0:  # the shapes' first use
            assert graphs == {"captures": 0, "replays": 0, "eager_bodies": gn["iterations"]}
        else:  # 3 windowed levels of 2 graphs a sweep, 2 exact levels of 1
            assert graphs == {"captures": 16 if k == 1 else 0, "replays": gn["iterations"] + 5, "eager_bodies": 0}


@pytest.mark.cuda
def test_threads_replay_graphs_of_their_own(cuda, monkeypatch):
    """Two threads, each on a stream of its own, align the same shapes
    three times at once (uncaptured, capture, replay) on different inputs,
    while a third makes device work and waits for it, as the SLAM app's
    planes worker does: every result bit-equal to the same align run alone
    uncaptured."""
    import threading

    from rgbd360_torch.ops import level_graphs, photoicp
    from rgbd360_torch.parallel import dryrun
    from rgbd360_torch.parallel.batch import align_batch

    gray, depth = (x.to(cuda) for x in dryrun.synthetic_pair(160, 960, 4))
    seeds = [dryrun.yawed_seeds(4).to(cuda), dryrun.yawed_seeds(4).transpose(-1, -2).contiguous().to(cuda)]
    monkeypatch.setattr(level_graphs, "use_cuda_graphs", lambda device: False)
    want = [align_batch(gray, depth, gray, depth, s, n_levels=2) for s in seeds]
    monkeypatch.undo()
    got, errors, stop = [[], []], [], threading.Event()

    def aligner(k):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                for _ in range(3):
                    got[k].append(align_batch(gray, depth, gray, depth, seeds[k], n_levels=2))
                torch.cuda.current_stream().synchronize()
        except BaseException as exc:
            errors.append(exc)

    def worker():
        # reads of device values, a copy waited on through its event, a
        # wait on its own stream: a device-wide torch.cuda.synchronize()
        # would be refused while another thread captures
        try:
            x = torch.arange(1 << 20, device=cuda, dtype=torch.float32)
            while not stop.is_set():
                if not (x * 2.0).sum().item() > 0:
                    raise AssertionError("the side thread's sum")
                host = (x + 1.0).to("cpu", non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
                torch.cuda.current_stream().synchronize()
                if float(host[-1]) != float(1 << 20):
                    raise AssertionError("the side thread's copy")
        except BaseException as exc:
            errors.append(exc)

    photoicp.reset_sweep_counts()
    side = threading.Thread(target=worker, daemon=True)
    side.start()
    threads = [threading.Thread(target=aligner, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    stop.set()
    side.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not side.is_alive()
    if errors:
        raise errors[0]
    for k in range(2):
        assert len(got[k]) == 3
        for n, res in enumerate(got[k]):
            dryrun.assert_same_result(res, want[k], f"thread {k} call {n}")
    # per thread 2 windowed levels, each 2 graphs for its first sweep and 2
    # for its loop body
    assert photoicp.GRAPHS["captures"] == 2 * 2 * 4


@pytest.mark.cuda
def test_frame_timing_sync_beside_a_capture(cuda, monkeypatch):
    """Frame360's timing brackets wait for their thread's stream, not the
    device: with the SLAM app's --lc-thread and stage timing on, the frame
    builds time their brackets while the loop closer's thread captures the
    aligner's CUDA graphs, and CUDA refuses a device-wide sync during a
    capture (the capture is lost and both threads raise). Here a capture
    is held open until another thread has made device work and run the
    bracket's sync; the align still equals the uncaptured one, bit for
    bit."""
    import threading
    import types

    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.ops import level_graphs, photoicp
    from rgbd360_torch.parallel import dryrun
    from rgbd360_torch.parallel.batch import align_batch

    gray, depth = (x.to(cuda) for x in dryrun.synthetic_pair(160, 960, 2))
    seeds = dryrun.yawed_seeds(2).to(cuda)
    monkeypatch.setattr(level_graphs, "use_cuda_graphs", lambda device: False)
    want = align_batch(gray, depth, gray, depth, seeds, n_levels=2)
    monkeypatch.undo()
    capturing, synced, errors, got, syncs = threading.Event(), threading.Event(), [], [], []
    first_project = photoicp._LevelLoop._first_project

    def held_open(self):  # holds the first sweep's capture open; uncaptured runs pass
        first_project(self)
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            synced.wait(timeout=120)

    monkeypatch.setattr(photoicp._LevelLoop, "_first_project", held_open)

    def aligner():
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                for _ in range(2):  # uncaptured, then captured and replayed
                    got.append(align_batch(gray, depth, gray, depth, seeds, n_levels=2))
                torch.cuda.current_stream().synchronize()
        except BaseException as exc:
            errors.append(exc)
        finally:
            capturing.set()

    def frame_builder():
        try:
            capturing.wait(timeout=300)
            frame = types.SimpleNamespace(device=cuda)
            x = torch.arange(1 << 20, device=cuda, dtype=torch.float32)
            for _ in range(3):
                y = x * 2.0
                Frame360._sync(frame)
                syncs.append(float(y[-1]))
        except BaseException as exc:
            errors.append(exc)
        finally:
            synced.set()

    threads = [threading.Thread(target=aligner), threading.Thread(target=frame_builder)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    assert syncs == [2.0 * ((1 << 20) - 1)] * 3
    assert len(got) == 2
    for n, res in enumerate(got):
        dryrun.assert_same_result(res, want, f"call {n}")


@pytest.mark.cuda
def test_the_loop_closer_thread_refines_on_its_own_stream_bit_for_bit(cuda, monkeypatch, tmp_path):
    """SphereGraphSLAM with --lc-thread on the card over a 5-capture arc (6
    deg steps; the loop closer's trajectory gap cut to 0.2 m so that it
    closes three loops, one through the facade, two in a batch): every
    align the loop closer's thread issues runs on the loop closer's stream,
    not the caller's, and each accepted closure's edge (pose and
    information) equals the synchronous session's bit for bit. Then a
    thread searches keyframe 4 three times over that map: its batch of two
    runs uncaptured, then is captured on its thread and replayed, each time
    bit-equal to the synchronous session's batch."""
    import threading

    from rgbd360_torch.apps import sphere_graph_slam as sgs
    from rgbd360_torch.apps.common import default_matcher_config
    from rgbd360_torch.core import loop_closure
    from rgbd360_torch.core.register_photoicp import RegisterPhotoICP
    from rgbd360_torch.ops import photoicp
    from tools import synthetic_rig as rig

    calib, seq = str(tmp_path / "calib"), str(tmp_path / "seq")
    rig.write_sequence(seq, rig.write_calib_root(calib), frames=5, loops=5 * 6.0 / 360.0, radius=0.8)
    argv = [seq, "--calib-root", calib, "--device", "cuda"]
    monkeypatch.setattr(loop_closure, "MIN_TRAJECTORY_GAP", 0.2)
    streams, batches = [], []
    real_batch, real_refine = loop_closure.align_batch, loop_closure.LoopClosure360._refine_batch
    real_align = RegisterPhotoICP.align_frames360

    def note():
        if threading.current_thread().name == "LoopClosure360":
            streams.append(torch.cuda.current_stream(cuda))

    def batch(*a, **k):
        note()
        return real_batch(*a, **k)

    def align(self, *a, **k):
        note()
        return real_align(self, *a, **k)

    def refine(self, new_kf, survivors):
        out = real_refine(self, new_kf, survivors)
        batches.append((new_kf.id, out))
        return out

    monkeypatch.setattr(loop_closure, "align_batch", batch)
    monkeypatch.setattr(RegisterPhotoICP, "align_frames360", align)
    monkeypatch.setattr(loop_closure.LoopClosure360, "_refine_batch", refine)
    sync = sgs.run(argv)
    threaded = sgs.run(argv + ["--lc-thread"])
    own = loop_closure.worker_of(threaded.loop_closer.device).stream
    assert len(streams) == 2 and all(s == own for s in streams)
    assert own != torch.cuda.current_stream(cuda) and own != torch.cuda.default_stream(cuda)
    accepted = sorted(sync.loop_closer.accepted)
    assert accepted == sorted(threaded.loop_closer.accepted) and len(accepted) == 3
    assert threaded.n_loop_closures == sync.n_loop_closures == 3
    for cand, kf, _b in accepted:
        for a, b in zip(sync.world.connection_kfs[kf][cand], threaded.world.connection_kfs[kf][cand]):
            assert np.array_equal(a, b), (cand, kf)

    # the synchronous session's batch, then the thread's
    assert [k for k, _out in batches] == [4, 4] and len(batches[0][1]) == 2
    want = batches[0][1]
    captures = photoicp.GRAPHS["captures"]
    lc = loop_closure.LoopClosure360(threaded.world, None, default_matcher_config(calib), device=cuda)
    lc.start()
    for _ in range(3):
        lc.notify_keyframe(4)
    lc.stop()
    assert photoicp.GRAPHS["captures"] > captures
    assert [k for k, _out in batches] == [4] * 5
    for _k, out in batches[1:]:
        for (c0, pose0, av0, h0, sso0), (c1, pose1, av1, h1, sso1) in zip(want, out):
            assert c0 == c1 and av0 == av1 and sso0 == sso1
            assert np.array_equal(pose0, pose1) and np.array_equal(h0, h1)


@pytest.mark.cuda
def test_graph_cache_stops_capturing_at_its_byte_bound(cuda, monkeypatch):
    """A thread captures a new key only if its graphs stay within
    GRAPH_BYTES_PER_THREAD with it: with a bound of one byte the second
    align captures the first level it meets (nothing foreseen yet) and runs
    the other uncaptured; a key of a larger batch of a level already held is
    foreseen from it and refused though the bound is not yet reached. Every
    align bit-equal to the uncaptured route."""
    from rgbd360_torch.ops import level_graphs, photoicp
    from rgbd360_torch.parallel import dryrun
    from rgbd360_torch.parallel.batch import align_batch

    gray, depth = (x.to(cuda) for x in dryrun.synthetic_pair(160, 960, 4))
    seeds = dryrun.yawed_seeds(4).to(cuda)

    def align(b):
        photoicp.reset_sweep_counts()
        return align_batch(gray[:b], depth[:b], gray[:b], depth[:b], seeds[:b], n_levels=2)

    monkeypatch.setattr(level_graphs, "use_cuda_graphs", lambda device: False)
    want = {b: align(b) for b in (2, 4)}
    monkeypatch.undo()
    photoicp.GRAPH_CACHE.release()
    assert photoicp.GRAPH_CACHE.held_bytes() == 0
    monkeypatch.setattr(level_graphs, "GRAPH_BYTES_PER_THREAD", 1)
    for k in range(3):
        dryrun.assert_same_result(align(2), want[2], f"call {k}")
        graphs = dict(photoicp.GRAPHS)
        if k == 0:
            assert graphs["captures"] == graphs["replays"] == 0
        else:  # one windowed level from its graphs (2 a sweep), the other uncaptured
            assert graphs["captures"] == (4 if k == 1 else 0)
            assert graphs["replays"] > 0 and graphs["eager_bodies"] > 0
    held = photoicp.GRAPH_CACHE.held_bytes()
    # at least the key's buffers: 2 pairs x 80 x 480 (the coarse level) x
    # (gray, depth, 8 planes, 8 gathered channels) f32
    assert 2 * 80 * 480 * 18 * 4 <= held < 1 << 30

    photoicp.GRAPH_CACHE.release()
    monkeypatch.setattr(level_graphs, "GRAPH_BYTES_PER_THREAD", 8 << 30)
    for k in range(2):  # both levels of 2 pairs held
        dryrun.assert_same_result(align(2), want[2], f"batch 2, call {k}")
    held = photoicp.GRAPH_CACHE.held_bytes()
    assert photoicp.GRAPHS["eager_bodies"] == 0 and held > 0
    monkeypatch.setattr(level_graphs, "GRAPH_BYTES_PER_THREAD", held + 1)
    for k in range(3):  # 4 pairs of either level would pass the bound
        dryrun.assert_same_result(align(4), want[4], f"batch 4, call {k}")
        assert photoicp.GRAPHS["captures"] == photoicp.GRAPHS["replays"] == 0
    assert photoicp.GRAPH_CACHE.held_bytes() == held
    photoicp.GRAPH_CACHE.release()
    assert photoicp.GRAPH_CACHE.held_bytes() == 0


@pytest.mark.cuda
def test_split_shard_threads_replay_their_graphs(cuda):
    """The mesh's shard threads outlive a call, so a split of the same
    shapes replays their CUDA graphs from its second call on: three splits
    over [cuda:0, cuda:0], each bit-equal to align_batch over the 8 pairs,
    the third with every loop body replayed."""
    from rgbd360_torch.ops import photoicp
    from rgbd360_torch.parallel import dryrun
    from rgbd360_torch.parallel import mesh as pmesh
    from rgbd360_torch.parallel.batch import align_batch

    gray, depth = (x.to(cuda) for x in dryrun.synthetic_pair(160, 960, 8))
    seeds = dryrun.yawed_seeds(8).to(cuda)
    whole = align_batch(gray, depth, gray, depth, seeds, n_levels=2, full_coverage=True)
    for k in range(3):
        photoicp.reset_sweep_counts()
        split = pmesh.align_batch_sharded([cuda, cuda], gray, depth, gray, depth, seeds, n_levels=2,
                                          full_coverage=True)
        torch.cuda.synchronize()
        dryrun.assert_same_result(split, whole, f"split call {k}")
    assert photoicp.GN["iterations"] > 0
    assert photoicp.GRAPHS == {"captures": 0, "replays": photoicp.GN["iterations"] + 2 * 2, "eager_bodies": 0}


@pytest.mark.cuda
def test_dryrun_multichip_on_one_card(cuda, capsys):
    """parallel/dryrun.py over [cuda:0, cuda:0]: every align leg's split
    and unsplit calls, op by op and from CUDA graphs, bit-equal; the
    kernel's launches equal to the windowed and full-coverage sweeps."""
    from rgbd360_torch.ops import photoicp
    from rgbd360_torch.parallel import dryrun

    photoicp.reset_sweep_counts()
    report = dryrun.dryrun_multichip(2, cuda)
    assert "dryrun_multichip OK: 2 shards of cuda" in capsys.readouterr().out
    assert photoicp.GRAPHS["replays"] > 0
    for leg in ("lc", "kernel"):
        launches, sweeps = report[leg]["launches"], report[leg]["sweeps"]
        assert launches["warp_gather_batched"] == sweeps["windowed"]
        assert launches["warp_gather_batched_multi"] == sweeps["full_coverage"] + sweeps["exact_final_dual"]
    assert report["lc"]["sweeps"]["full_coverage"] > 0 and report["kernel"]["sweeps"]["windowed"] > 0


# -- the plane refinement's growth loop (csrc/planes_refine.cu) ---------------------

def float_refine_scene(s, h, w, seed):
    """grow_labels inputs at (s, h, w) in floats: blocks of 8 x 8 on five
    random planes, each a model region, a non-model one, open pixels or
    invalid ones. Half the open points sit well inside or outside the
    0.02 m threshold, half within ~1e-5 of it, where only the fit's exact
    rounding decides."""
    from test_torch_planes_refine import THR

    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(5, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    offsets = rng.uniform(1.0, 3.0, 5)
    bh, bw = -(-h // 8), -(-w // 8)
    plane = np.repeat(np.repeat(rng.integers(0, 5, (s, bh, bw)), 8, 1), 8, 2)[:, :h, :w]
    kind = np.repeat(np.repeat(rng.choice(4, size=(s, bh, bw), p=[0.3, 0.1, 0.5, 0.1]), 8, 1), 8, 2)[:, :h, :w]
    label = np.repeat(np.repeat(rng.integers(0, h * w, (s, bh, bw)), 8, 1), 8, 2)[:, :h, :w]
    n, d = normals[plane], offsets[plane]
    q = rng.uniform(-2.0, 2.0, (s, h, w, 3))
    q -= ((q * n).sum(-1) - d)[..., None] * n  # on the plane
    near = rng.random((s, h, w)) < 0.5
    off = np.where(near, THR * (1.0 + rng.uniform(-2e-5, 2e-5, (s, h, w))) * rng.choice([-1.0, 1.0], (s, h, w)),
                   rng.uniform(-1.6 * THR, 1.6 * THR, (s, h, w)))
    p = (q + off[..., None] * n).astype(np.float32)
    valid = kind != 3
    p[~valid] = 0.0
    model = kind == 0
    return dict(
        lab=np.where(model, label, -1).astype(np.int32),
        n=np.where(model[..., None], n, rng.normal(size=n.shape)).astype(np.float32),
        d=np.where(model, d, rng.normal(size=d.shape)).astype(np.float32),
        static=kind == 1, valid=valid, p=p,
    )


def assert_kernel_equals_plain_loop(sc, cuda, max_sweeps=None, thr=None):
    """The kernel's labels and per-sensor rounds against the plain loop on
    the card, over the batch and over each sensor alone."""
    from test_torch_planes_refine import THR, grow_args

    from rgbd360_torch.ops import planes_seg

    thr = THR if thr is None else thr
    args = grow_args(sc, cuda)
    before = planes_seg.REFINE["kernel"]
    got, rounds = planes_seg.grow_labels(*args, thr, max_sweeps)
    torch.cuda.synchronize()
    assert planes_seg.REFINE["kernel"] == before + 1
    want, want_rounds = planes_seg.grow_labels_plain(*args, thr, max_sweeps or sc["lab"][0].size)
    assert torch.equal(got, want)
    per_sensor = rounds.cpu().tolist()
    assert max(per_sensor) == want_rounds
    for i in range(len(per_sensor)):
        one = [a[i:i + 1].contiguous() for a in args]
        assert planes_seg.grow_labels_plain(*one, thr, max_sweeps or sc["lab"][0].size)[1] == per_sensor[i]
    return per_sensor


@pytest.mark.cuda
def test_refine_growth_kernel_equals_the_plain_loop_on_crafted_scenes(cuda):
    """The CPU file's lattice scenes (contested pixels, non-model regions,
    NaN pixels, an idle sensor, a max_sweeps cut) and float scenes at the
    sensor program's shape, whose fits sit on the threshold."""
    from test_torch_planes_refine import REFINE_SCENES, refine_scene

    for name in REFINE_SCENES:
        sc, max_sweeps = refine_scene(name)
        per_sensor = assert_kernel_equals_plain_loop(sc, cuda, max_sweeps)
        if name == "idle_sensor":
            assert per_sensor[1] == 1 and per_sensor[0] > 1
        if name == "corridor_cut":
            assert per_sensor == [max_sweeps]
    for seed in (1, 2):
        per_sensor = assert_kernel_equals_plain_loop(float_refine_scene(8, 120, 160, seed), cuda)
        assert max(per_sensor) > 2
    assert_kernel_equals_plain_loop(float_refine_scene(8, 120, 160, 3), cuda, max_sweeps=3)


@pytest.mark.cuda
def test_refine_growth_kernel_at_the_stereo_panorama_shape(cuda):
    """One sensor of 1024 x 180, the stereo panorama's shape, with its
    threshold 0.05: one block sweeps 184,320 pixels a round."""
    per_sensor = assert_kernel_equals_plain_loop(float_refine_scene(1, 180, 1024, 4), cuda, thr=0.05)
    assert per_sensor[0] > 2


@pytest.mark.cuda
def test_refine_growth_kernel_on_loop40_captures(cuda, monkeypatch, tmp_path):
    """All 8 sensors of loop40 captures 0, 7 and 15 (the SLAM cell's circle:
    1.1 m, 9 deg a step, calibration seed 0) through Frame360.
    build_device_fused: the growth loop's inputs as the frame program makes
    them, kernel against plain loop on the card, labels and rounds; and the
    whole stats buffer of the kernel route byte-equal to the plain loop's."""
    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.io.calib import Calib360
    from rgbd360_torch.ops import planes_seg
    from tools import synthetic_rig as rig

    rts = rig.write_calib_root(str(tmp_path))
    calib = Calib360.load(str(tmp_path))
    kernel_route = planes_seg.grow_labels
    seen = []

    def spy(*args):
        seen.append(args)
        return kernel_route(*args)

    rounds = {}
    for i in (0, 7, 15):
        frame = Frame360(calib, i, cuda)
        frame.set_raw(rig.room_capture(rig.loop_pose(2.0 * np.pi * i / 40, 1.1), rts))
        monkeypatch.setattr(planes_seg, "grow_labels", spy)
        stats = frame.build_device_fused(ship_labels=True)
        monkeypatch.setattr(planes_seg, "grow_labels", lambda *a: planes_seg.grow_labels_plain(*a))
        host_loops = planes_seg.REFINE["host_loop"]
        stats_plain = frame.build_device_fused(ship_labels=True)
        assert planes_seg.REFINE["host_loop"] == host_loops + 1
        assert torch.equal(stats, stats_plain)
        args = seen[-1]
        got, k_rounds = kernel_route(*args)
        want, want_rounds = planes_seg.grow_labels_plain(*args)
        assert torch.equal(got, want)
        rounds[i] = k_rounds.cpu().tolist()
        assert max(rounds[i]) == want_rounds
        for s in range(8):
            one = [a[s:s + 1].contiguous() for a in args[:6]] + list(args[6:])
            assert planes_seg.grow_labels_plain(*one)[1] == rounds[i][s]
    print(f"rounds per sensor: {rounds}")
    assert max(rounds[7]) >= 100


@pytest.mark.cuda
def test_refine_growth_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from test_torch_planes_refine import THR, grow_args, refine_scene

    from rgbd360_torch.ops import planes_seg

    args = grow_args(refine_scene("lattice")[0], cuda)

    def call(i, t):
        planes_seg.grow_labels(*(args[:i] + [t] + args[i + 1:]), THR)

    with pytest.raises(ValueError):
        call(0, args[0].to(torch.int64))  # dtype
    with pytest.raises(ValueError):
        call(1, args[1].to(torch.float64))
    with pytest.raises(ValueError):
        call(3, args[3].to(torch.uint8))
    with pytest.raises(ValueError):
        call(5, args[5][:, :, :-1].contiguous())  # shape
    with pytest.raises(ValueError):
        call(5, args[5].transpose(1, 2).contiguous().transpose(1, 2))  # contiguity
    with pytest.raises(ValueError):
        call(2, args[2].cpu())  # two devices
    with pytest.raises(ValueError):
        planes_seg.grow_labels(*(a[:0] for a in args), THR)  # no sensor
