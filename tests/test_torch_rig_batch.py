"""The robot-frame dense registration batched over pairs
(rgbd360_torch/parallel/batch.py::align_batch_rig, the level loop of
ops/photoicp_pinhole.py) on the CPU, at a small size: 8 sensors of 48 x 64
on the construction-spec rig in the benchmark's room (bench360/lib/rig.py),
3 pyramid levels, seeded rig poses and motions.

The batch of three holds a pair that takes the Levenberg-Marquardt retry at
every level, a pair that is ill-posed at its coarse levels only (one
sensor sees a constant-gray surface whose depth ripple the pyramid averages
flat, so no step has a t_x, t_y or yaw column there; its finest level is
well-posed and runs, with the pose frozen) and a third pair.

Tolerances:
  * the batch against each pair alone: equal, bit for bit. Every product
    and reduction of a pair has the same shape whatever B
    (ops/photoicp.py::_matmul_unrolled, photoicp_pinhole._rig_grams), so B
    changes no rounding;
  * the program against the plain reference (bench360/reference/pinhole.py):
    equal, bit for bit: the reference computes the same f32 operations in
    the same order on the same device, its loop scalars as host f32, which
    round as the device's f32 carry. A planted lower precision (the sweep's
    sums from bfloat16 rows) must fail: it moves the poses by 2e-4 to 5e-4,
    H by ~2e-3 of its scale, and one pair's iterations.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from bench360.lib import rig  # noqa: E402
from bench360.reference import image as ref_image  # noqa: E402
from bench360.reference import pinhole as ref_pinhole  # noqa: E402
from rgbd360_torch.ops import photoicp_pinhole as pp  # noqa: E402
from rgbd360_torch.parallel.batch import align_batch_rig  # noqa: E402
from rgbd360_torch.utils import timing  # noqa: E402

H, W, LEVELS = 48, 64, 3
K = rig.qvga_camera_matrix() * np.float32(0.2)
K[2, 2] = 1.0
RTS = rig.construction_specs()


def _capture(pose):
    """(gray, depth metres), each (8, H, W) f32, of the rig at ``pose``."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, float)], -1)
    grays, depths = [], []
    for s in range(8):
        rt = pose @ RTS[s]
        best, face, hit = rig._raycast(rt[:3, 3], d_cam @ rt[:3, :3].T, rig.DEFAULT_BOX, rig.OBSTACLES)
        depth_mm = np.clip(np.nan_to_num(best * d_cam[..., 2]) * 1000.0, 0, 60000).astype(np.uint16)
        grays.append(ref_image.gray_f32(torch.from_numpy(rig._shade(hit, face))))
        depths.append(torch.from_numpy(depth_mm.astype(np.float32) * np.float32(0.001)))
    return torch.stack(grays), torch.stack(depths)


def _pair(seed):
    """(gray_src, depth_src, gray_trg, depth_trg, true motion): the rig on
    the room's circle, then turned 3-8 deg about the vertical and moved ~4
    cm, both drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    trg = rig.loop_pose(rng.uniform(0, 2 * np.pi), 0.8)
    a = np.deg2rad(rng.uniform(3.0, 8.0))
    step = np.eye(4)
    step[1, 1] = step[2, 2] = np.cos(a)
    step[1, 2], step[2, 1] = -np.sin(a), np.sin(a)
    step[:3, 3] = rng.normal(0.0, 0.04, 3)
    return (*_capture(trg @ step), *_capture(trg), step)


def _ill_at_coarse_levels(seed):
    """Sensor 0 alone sees anything of the source: a constant gray and a
    depth ripple of period 4 (2 px shifted between source and target) whose
    2 x 2 averages are constant, so the coarse levels constrain only t_z,
    roll and pitch (sensor 0 looks along the robot's z)."""
    gs, ds, gt, dt, _ = _pair(seed)
    saw = np.array([1.0, 2.0, 3.0, 0.0], np.float32)
    r, c = np.mgrid[0:H, 0:W]
    ripple = lambda shift: torch.from_numpy((2.0 + 0.1 * (saw[(c + shift) % 4] + saw[r % 4])).astype(np.float32))
    ds = torch.zeros_like(ds)
    ds[0], dt[0] = ripple(2), ripple(0)
    gs[0], gt[0] = 0.5, 0.5
    return gs, ds, gt, dt, None


@pytest.fixture(scope="module")
def batch():
    """The three pairs stacked: (gray_src, depth_src, gray_trg, depth_trg)
    (3, 8, H, W) each, and the true motions (None for the ill-posed pair)."""
    pairs = [_pair(1), _ill_at_coarse_levels(11), _pair(4)]
    return tuple(torch.stack([p[j] for p in pairs]) for j in range(4)), [p[4] for p in pairs]


def _align(images, method=pp.PHOTO_DEPTH):
    b = images[0].shape[0]
    return align_batch_rig(*images, torch.from_numpy(RTS.astype(np.float32)), torch.from_numpy(K),
                           torch.eye(4).expand(b, 4, 4), method=method, n_levels=LEVELS)


@pytest.mark.parametrize("method", [pp.PHOTO_DEPTH, pp.PHOTO_CONSISTENCY, pp.DEPTH_CONSISTENCY],
                         ids=["photo_depth", "photo", "depth"])
def test_a_batch_equals_its_pairs_aligned_one_by_one(batch, method):
    images, motions = batch
    pp.reset_sweep_counts()
    together = _align(images, method)
    retries = []
    for b in range(3):
        pp.reset_sweep_counts()
        alone = _align(tuple(x[b:b + 1] for x in images), method)
        retries.append(pp.GN["pair_retries"])
        for name, a, o in zip(pp.PinholeAlignResult._fields, together, alone):
            assert a.shape[0] == 3 and torch.equal(a[b], o[0]), (b, name)
    assert together.ill_posed.tolist() == [False, True, False]
    assert torch.equal(together.pose[1], torch.eye(4))  # frozen at the guess
    assert retries[0] >= 1
    if method == pp.PHOTO_DEPTH:
        for b in (0, 2):
            assert np.abs(together.pose[b].numpy() - motions[b]).max() < 5e-3
        # the ill pair's finest level is well-posed: it ran, its pose thrown away
        assert together.num_iterations[1].tolist()[:2] == [0, 0] and int(together.num_iterations[1, 2]) > 0
        lone = align_batch_rig(*(x[1:2] for x in images), torch.from_numpy(RTS.astype(np.float32)),
                               torch.from_numpy(K), torch.eye(4)[None], n_levels=1)
        assert not bool(lone.ill_posed[0]) and int(lone.num_iterations[0, 0]) > 0


_RIG_GRAMS = pp._rig_grams


def _bf16_grams(rows, shape):
    """The sweep's sums from bfloat16 rows: the planted lower precision."""
    return _RIG_GRAMS(rows.to(torch.bfloat16), shape).to(torch.float32)


@pytest.mark.parametrize("planted", [False, True], ids=["program", "bf16_sums"])
def test_the_program_equals_the_plain_reference(batch, monkeypatch, planted):
    images, _ = batch
    if planted:
        monkeypatch.setattr(pp, "_rig_grams", _bf16_grams)
    prog = _align(images)
    gaps = {"pose": 0.0, "hessian": 0.0, "residuals": 0.0, "iters": 0, "ill": 0}
    for b in range(3):
        ref = ref_pinhole.register(*(x[b] for x in images), RTS.astype(np.float32), K, np.eye(4, dtype=np.float32),
                                   n_levels=LEVELS)
        gaps["pose"] = max(gaps["pose"], float(np.abs(prog.pose[b].numpy() - ref["pose"]).max()))
        h_ref = ref["hessian"]
        gaps["hessian"] = max(gaps["hessian"], float(np.abs(prog.hessian[b].numpy() - h_ref).max() / np.abs(h_ref).max()))
        for key, got in (("error", prog.error), ("av_photo", prog.av_photo_residual), ("av_depth", prog.av_depth_residual)):
            gaps["residuals"] = max(gaps["residuals"], abs(float(got[b]) - ref[key]) / max(ref[key], 1e-6))
        gaps["iters"] += int(np.abs(prog.num_iterations[b].numpy() - ref["iters"]).sum())
        gaps["ill"] += int(bool(prog.ill_posed[b]) != ref["ill"])
    within = all(v == 0 for v in gaps.values())
    assert within != planted, gaps
    if planted:
        assert gaps["pose"] > 1e-6 and gaps["hessian"] > 1e-4, gaps


@pytest.mark.parametrize("pairs", [1, 3])
def test_one_read_per_iteration_and_one_per_retry_round(batch, pairs):
    """Each level sweeps once before its loop, once per loop body and once
    per retry round; the loop reads the batch's flags once per body and once
    more per retry round, and not at a level's start; the spans nest."""
    images, _ = batch
    timing.reset_timing()
    timing.stage_timing(True)
    try:
        pp.reset_sweep_counts()
        assert set(pp.GN.values()) == {0}
        _align(tuple(x[:pairs] for x in images))
        gn, sweeps = dict(pp.GN), dict(pp.SWEEPS)
        records = timing.span_records()
    finally:
        timing.stage_timing(False)
        timing.reset_timing()
    rounds = sweeps["lm_retries"]
    assert gn["iterations"] > 0 and rounds > 0
    assert gn["syncs"] == gn["iterations"] + rounds
    assert sweeps["sweeps"] == LEVELS + gn["iterations"] + rounds
    assert rounds <= gn["pair_retries"] <= pairs * rounds
    assert gn["host_ns"] >= gn["wait_ns"] > 0
    by_name = lambda name: [s for s in records if s.name == name]
    (align,) = by_name("rig align")
    assert align.attrs == {"B": pairs, "levels": LEVELS}
    levels = by_name("rig level")
    assert sorted(s.attrs["level"] for s in levels) == list(range(LEVELS)) and all(s.parent == align.id for s in levels)
    assert len(by_name("rig iteration")) == gn["iterations"] and len(by_name("GN sync")) == gn["syncs"]


def test_the_facade_registers_through_the_batched_loop(batch, monkeypatch):
    """RegisterRGBD360.register_dense_photoicp is align_batch_rig at B = 1
    on the frames' raw sensors."""
    from types import SimpleNamespace

    from rgbd360_torch.core import register_rgbd360
    from rgbd360_torch.parallel import batch as pbatch

    pose = rig.loop_pose(0.3, 0.8)
    step = np.eye(4)
    step[:3, 3] = [0.01, -0.02, 0.015]
    rts = torch.from_numpy(RTS.astype(np.float32))
    calib = SimpleNamespace(device_extrinsic_arrays=lambda dev: (rts, torch.linalg.inv(rts), torch.from_numpy(K)))

    def frame(p):
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, float)], -1)
        rgb, depth = [], []
        for s in range(8):
            rt = p @ RTS[s]
            best, face, hit = rig._raycast(rt[:3, 3], d_cam @ rt[:3, :3].T, rig.DEFAULT_BOX, rig.OBSTACLES)
            rgb.append(rig._shade(hit, face))
            depth.append(np.clip(np.nan_to_num(best * d_cam[..., 2]) * 1000.0, 0, 60000).astype(np.uint16))
        return SimpleNamespace(rgb=torch.from_numpy(np.stack(rgb)), depth_raw_mm=torch.from_numpy(np.stack(depth)),
                               device=torch.device("cpu"), calib=calib)

    f1, f2 = frame(pose), frame(pose @ step)
    calls = []
    real = pbatch.align_batch_rig

    def spy(*args, **kwargs):
        calls.append((args[0].shape, real(*args, **kwargs)))
        return calls[-1][1]

    monkeypatch.setattr(pbatch, "align_batch_rig", spy)
    reg = register_rgbd360.RegisterRGBD360()
    assert reg.register_dense_photoicp(f1, f2, n_levels=LEVELS, method=pp.PHOTO_DEPTH)
    ((shape, res),) = calls
    assert shape == (1, 8, H, W)
    got = reg.get_pose()
    assert got.dtype == np.float32 and np.array_equal(got, res.pose[0].numpy())
    assert np.array_equal(reg.get_info_mat(), res.hessian[0].numpy())
    assert np.abs(got[:3, 3] - step[:3, 3]).max() < 1e-2


def _room_captures(dev, n):
    """(gray, depth metres), each (8, 240, 320) on ``dev``, of the rig at
    the first ``n`` poses of the room's circle (6 deg, ~8.4 cm a step)."""
    caps = []
    for p in rig.circle_poses(n, 6.0, 0.8):
        gray, depth = [], []
        for s in range(8):
            rgb, d = rig.raycast_room_sensor(p @ RTS[s], obstacles=rig.OBSTACLES)
            gray.append(ref_image.gray_f32(torch.from_numpy(rgb)))
            depth.append(torch.from_numpy(d).to(torch.float32) * 0.001)
        caps.append((torch.stack(gray).to(dev), torch.stack(depth).to(dev)))
    return caps


@pytest.mark.cuda
def test_on_the_card_a_batch_equals_its_pairs_and_the_reference():
    """At the deployment's size (8 x 240 x 320, 4 levels) on the card: four
    consecutive pairs of the room's circle at batch 4 equal each pair at
    batch 1 and the plain reference, bit for bit (tests/test_torch_rig_batch.py's
    tolerances, for the card's kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rts = RTS.astype(np.float32)
    k = rig.qvga_camera_matrix()
    caps = _room_captures(dev, 5)
    stack = lambda frames, part: torch.stack([caps[f][part] for f in frames])
    src, trg = [1, 2, 3, 4], [0, 1, 2, 3]
    args = lambda b: (stack([src[i] for i in b], 0), stack([src[i] for i in b], 1), stack([trg[i] for i in b], 0),
                      stack([trg[i] for i in b], 1), torch.from_numpy(rts).to(dev), torch.from_numpy(k).to(dev),
                      torch.eye(4, device=dev).expand(len(b), 4, 4))
    together = align_batch_rig(*args(range(4)))
    for b in range(4):
        alone = align_batch_rig(*args([b]))
        for name, a, o in zip(pp.PinholeAlignResult._fields, together, alone):
            assert torch.equal(a[b], o[0]), (b, name)
    ref = ref_pinhole.register(caps[1][0], caps[1][1], caps[0][0], caps[0][1], rts, k, np.eye(4, dtype=np.float32))
    assert np.array_equal(together.pose[0].cpu().numpy(), ref["pose"])
    assert together.num_iterations[0].tolist() == ref["iters"].tolist()
    # 6 deg about the vertical and ~8.4 cm per step
    assert 0.07 < float(torch.linalg.vector_norm(together.pose[0, :3, 3])) < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 1])
def test_on_the_card_the_graph_path_equals_the_eager_path(monkeypatch, b):
    """At the deployment's size (8 x 240 x 320, 4 levels) on the card: aligns
    of the same shapes on inputs A, A, B, A replay the level loop from CUDA
    graphs from the second on (the first runs op by op, the second captures
    three graphs a level), and each equals the op-by-op loop, forced by the
    routing predicate, in every PinholeAlignResult field, bit for bit, and
    in its counts: sweeps, retry rounds, iterations, syncs, pairs retried.
    B (the pairs swapped) would show a stale buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rgbd360_torch.ops import photoicp

    dev = torch.device("cuda")
    caps = _room_captures(dev, b + 1)
    rts, k = torch.from_numpy(RTS.astype(np.float32)).to(dev), torch.from_numpy(rig.qvga_camera_matrix()).to(dev)
    stack = lambda frames, part: torch.stack([caps[f][part] for f in frames])
    args = lambda src, trg: (stack(src, 0), stack(src, 1), stack(trg, 0), stack(trg, 1), rts, k,
                             torch.eye(4, device=dev).expand(b, 4, 4))
    inputs = {"A": args(range(1, b + 1), range(b)), "B": args(range(b), range(1, b + 1))}

    def align(name):
        pp.reset_sweep_counts()
        res = align_batch_rig(*inputs[name])
        torch.cuda.synchronize()
        gn = {key: v for key, v in pp.GN.items() if key not in ("host_ns", "wait_ns")}
        return res, gn, dict(pp.SWEEPS), dict(pp.GRAPHS)

    monkeypatch.setattr(photoicp, "_use_cuda_graphs", lambda device: False)
    eager = {name: align(name) for name in inputs}
    monkeypatch.undo()
    pp.release_graphs()
    for n, name in enumerate("AABA"):
        res, gn, sweeps, graphs = align(name)
        want, want_gn, want_sweeps, want_graphs = eager[name]
        for field, a, o in zip(pp.PinholeAlignResult._fields, res, want):
            bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
            assert torch.equal(bits(a), bits(o)), (n, name, field)
        assert gn == want_gn and sweeps == want_sweeps, (n, name)
        assert gn["iterations"] > 0 and want_graphs["eager_bodies"] == gn["iterations"]
        if n == 0:  # the shapes' first use
            assert graphs == {"captures": 0, "replays": 0, "eager_bodies": gn["iterations"]}
        else:  # 4 levels of 3 graphs; a replay per first sweep, body and retry round
            assert graphs == {"captures": 12 if n == 1 else 0, "eager_bodies": 0,
                              "replays": 4 + gn["iterations"] + sweeps["lm_retries"]}
    held = pp.held_graph_bytes()
    print(f"batch {b}: the level loop's graphs hold {held} B; sweeps {sweeps}, GN {gn}")
    assert 0 < held <= photoicp.GRAPH_BYTES_PER_THREAD
    pp.release_graphs()
    assert pp.held_graph_bytes() == 0
