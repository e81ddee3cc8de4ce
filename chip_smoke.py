"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path — dense spherical photo+depth pair
registration of the bundled golden pair (tests/golden/pair_1_10.npz) at
1920x320, 5 pyramid levels, PHOTO_DEPTH, batch 8 — through the entry points
a user calls, and checks it end to end:

  1. a CUDA device is present; print the card's name and power limit;
  2. build the CUDA kernels from rgbd360_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path (L0, L1, L2; batch 8; real warps, a seam-
     straddling yaw and a two-band parallax case; every row policy and
     anchor set): out (as int32 bits) and mask must be identical;
  4. parallel.batch.align_batch at batch 8: every pair passes
     bench.sanity_check(kernel_path=True), the 8 identical pairs agree, and
     the kernel launch counts of that run equal the windowed sweeps it ran
     plus one dual-anchored pass;
  5. the RegisterPhotoICP facade on one pair;
  6. timing with CUDA events: warm align throughput on the default
     (windowed kernel) and the exact route, in alternating rounds, and each
     kernel beside its plain version at the L0 shape.

Any failed check raises, and the script exits non-zero. The last line of
its output is the JSON status line. Run from the repository root:

    python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from rgbd360_torch.device import require_cuda  # noqa: E402

BATCH = 8
N_LEVELS = 5
TIMED_ALIGNS = 3
ROUTE_ROUNDS = 10
TIMED_GATHERS = 20


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds per call of fn over n warm calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def yaw(angle: float) -> np.ndarray:
    """Rotation about the panorama's vertical (x) axis: a pure theta shift."""
    c, s = np.cos(angle), np.sin(angle)
    pose = np.eye(4)
    pose[1:3, 1:3] = [[c, -s], [s, c]]
    return pose


def main() -> int:
    dev = require_cuda()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    import bench  # the repo's sanity rails; imports only numpy
    from rgbd360_torch.core.register_photoicp import RegisterPhotoICP
    from rgbd360_torch.kernels import build
    from rgbd360_torch.ops import photoicp, warp_gather
    from rgbd360_torch.ops.sphere import sphere_xyz_lut
    from rgbd360_torch.parallel.batch import align_batch

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_SECONDS})", flush=True)

    golden = np.load(os.path.join(REPO, "tests", "golden", "pair_1_10.npz"))
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(np.broadcast_to(a, (BATCH,) + a.shape))).to(dev)
    gray_src = to_dev(golden["gray_src_u8"].astype(np.float32) / 255.0)
    depth_src = to_dev(golden["depth_src_mm"].astype(np.float32) * 0.001)
    gray_trg = to_dev(golden["gray_trg_u8"].astype(np.float32) / 255.0)
    depth_trg = to_dev(golden["depth_trg_mm"].astype(np.float32) * 0.001)
    eye = torch.eye(4, device=dev).expand(BATCH, 4, 4).contiguous()

    # -- 3. kernels against their plain versions ------------------------------
    src = photoicp.build_pyramid_set(gray_src, depth_src, N_LEVELS, is_target=False, sphere_seam_mask=True)
    trg = photoicp.build_pyramid_set(gray_trg, depth_trg, N_LEVELS, is_target=True, sphere_seam_mask=True)
    max_err = {"warp_gather_batched": 0.0, "warp_gather_batched_multi": 0.0}
    l0_operands = None
    for lv in (0, 1, 2):
        level = photoicp.make_level_data(src, trg, lv)
        h, w = level.gray_src.shape[-2:]
        planes = photoicp.pack_target_planes8(level)
        pose_in = golden["free_level_pose_in"][N_LEVELS - 1 - lv]
        # all but the last two members: the real warp at the golden incoming
        # pose, yawed a little apart; the second last: yawed by 1 rad, so
        # tiles straddle the seam; the last: the real warp split into two
        # parallax bands 20 rows apart
        yaws = [0.002 * ((k + 1) // 2) * (-1) ** k for k in range(BATCH - 2)] + [1.0, 0.0]
        poses = torch.from_numpy(np.stack([yaw(a) @ pose_in for a in yaws]).astype(np.float32)).to(dev)
        xyz, valid = sphere_xyz_lut(level.depth_src, photoicp.MIN_DEPTH, photoicp.MAX_DEPTH)
        _p, _d, visible, rc, cc = photoicp._project_indices(xyz, valid, poses, h, w)
        r2d, c2d, vis2d = photoicp._kernel_coords(visible, rc, cc, h, w)
        band = torch.where(torch.arange(w, device=dev) % 2 == 0, -10, 10).to(torch.int32)
        r2d[-1] = torch.clamp(r2d[-1] + band, 0, h - 1)
        r2d, c2d = r2d.contiguous(), c2d.contiguous()
        miss = (vis2d & ~warp_gather.window_mask_reference(r2d, c2d)).contiguous()
        cases = [
            ("warp_gather_batched", "mean", None), ("warp_gather_batched", "min", vis2d),
            ("warp_gather_batched", "max", vis2d),
            ("warp_gather_batched_multi", warp_gather.DUAL, miss),
            ("warp_gather_batched_multi", warp_gather.FULL, vis2d),
        ]
        for name, how, active in cases:
            if name == "warp_gather_batched":
                got = warp_gather.warp_gather_batched(planes, r2d, c2d, active, row_policy=how)
                want = warp_gather.warp_gather_batched_plain(planes, r2d, c2d, active, row_policy=how)
            else:
                got = warp_gather.warp_gather_batched_multi(planes, r2d, c2d, active, anchors=how)
                want = warp_gather.warp_gather_batched_multi_plain(planes, r2d, c2d, active, anchors=how)
            torch.cuda.synchronize()
            same_bits = bool(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)))
            same_mask = bool(torch.equal(got[1], want[1]))
            err = float((got[0] - want[0]).abs().max())
            max_err[name] = max(max_err[name], err)
            print(f"kernel vs plain L{lv} {h}x{w} {name} {how}: bits {same_bits} mask {same_mask} "
                  f"coverage {float(got[1].float().mean()):.4f} max_abs_err {err}", flush=True)
            if not (same_bits and same_mask):
                raise AssertionError(f"kernel disagrees with its plain version: L{lv} {name} {how}")
        if lv == 0:
            l0_operands = (planes, r2d, c2d, miss)

    # -- 4. the main path ---------------------------------------------------------
    warp_gather.reset_launch_counts()
    photoicp.reset_sweep_counts()
    res = align_batch(gray_src, depth_src, gray_trg, depth_trg, eye, photoicp.PHOTO_DEPTH, N_LEVELS)
    torch.cuda.synchronize()
    launches = dict(warp_gather.LAUNCHES)
    sweeps = dict(photoicp.SWEEPS)
    poses = res.pose.cpu().numpy()
    for i in range(BATCH):
        ok, reasons = bench.sanity_check(
            poses[i], float(res.error[i]), bool(res.ill_posed[i]), res.num_iterations[i].cpu().numpy(),
            golden=golden, kernel_path=True,
        )
        if not ok:
            raise AssertionError(f"pair {i} fails the kernel-path rails: {reasons}")
    spread = float(np.abs(poses - poses[0]).max())
    print(f"align_batch B={BATCH}: signature {tuple(res.num_iterations[0].tolist())} "
          f"|t| {np.linalg.norm(poses[0][:3, 3]):.6f} m error {float(res.error[0]):.6f} "
          f"pose spread over the batch {spread:.3g}", flush=True)
    print(f"launches {launches} sweeps {sweeps}", flush=True)
    if spread > 1e-6:
        raise AssertionError(f"identical pairs disagree: pose spread {spread}")
    if not (launches["warp_gather_batched"] == sweeps["windowed"] > 0
            and launches["warp_gather_batched_multi"] == sweeps["exact_final_dual"] == 1):
        raise AssertionError(f"the main path did not run through the kernels: {launches} vs {sweeps}")

    # -- 5. the facade ------------------------------------------------------------
    reg = RegisterPhotoICP(n_pyr_levels=N_LEVELS, device=dev)
    bgr = lambda key: torch.from_numpy(np.repeat(golden[f"gray_{key}_u8"][..., None], 3, axis=-1)).to(dev)
    reg.set_source_frame(bgr("src"), torch.from_numpy(golden["depth_src_mm"].astype(np.int32)).to(torch.uint16).to(dev))
    reg.set_target_frame(bgr("trg"), torch.from_numpy(golden["depth_trg_mm"].astype(np.int32)).to(torch.uint16).to(dev))
    pose = reg.align_frames360(method=photoicp.PHOTO_DEPTH)
    entropy = reg.calc_entropy()
    print(f"facade: pose t {pose[:3, 3].tolist()} iterations {reg.num_iterations.tolist()} "
          f"av_depth_residual {reg.av_depth_residual:.6f} sso {reg.sso:.6f} entropy {entropy:.4f}", flush=True)
    facade_ok, reasons = bench.sanity_check(
        pose, reg.result.error[0].item(), reg.ill_posed, reg.num_iterations, golden=golden, kernel_path=True,
    )
    if not (facade_ok and np.isfinite(entropy)):
        raise AssertionError(f"facade result fails the rails: {reasons} entropy {entropy}")

    # -- 6. timing -------------------------------------------------------------------
    # The two routes alternate, each leading every other round, so drift of
    # the card or its host falls on both alike; each reports its median.
    run = lambda: align_batch(gray_src, depth_src, gray_trg, depth_trg, eye, photoicp.PHOTO_DEPTH, N_LEVELS)
    routed = photoicp._use_warp_kernel
    routes = {"windowed": routed, "exact": lambda shape, device: False}
    samples = {name: [] for name in routes}
    try:
        photoicp._use_warp_kernel = routes["exact"]
        res_exact = run()
        for k in range(ROUTE_ROUNDS):
            for name in (("windowed", "exact") if k % 2 == 0 else ("exact", "windowed")):
                photoicp._use_warp_kernel = routes[name]
                samples[name].append(cuda_ms(run, TIMED_ALIGNS))
    finally:
        photoicp._use_warp_kernel = routed
    ms_route = {name: float(np.median(ms)) for name, ms in samples.items()}
    faster = sum(w < e for w, e in zip(samples["windowed"], samples["exact"]))
    print(f"[{card}] align_batch B={BATCH} 1920x320 5 levels PHOTO_DEPTH, median of {ROUTE_ROUNDS} "
          f"alternating rounds of {TIMED_ALIGNS} aligns: "
          + "; ".join(f"{name} route {ms:.3f} ms/batch = {BATCH * 1000.0 / ms:.2f} pairs/s"
                      for name, ms in ms_route.items())
          + f"; windowed faster in {faster} of {ROUTE_ROUNDS} rounds "
          f"(exact-route signature {tuple(res_exact.num_iterations[0].tolist())}, "
          f"error {float(res_exact.error[0]):.6f})", flush=True)
    print(f"route samples ms/batch: {json.dumps(samples)}", flush=True)

    planes, r2d, c2d, miss = l0_operands
    timing = {
        "warp_gather_batched": (
            lambda: warp_gather.warp_gather_batched(planes, r2d, c2d),
            lambda: warp_gather.warp_gather_batched_plain(planes, r2d, c2d),
        ),
        "warp_gather_batched_multi": (
            lambda: warp_gather.warp_gather_batched_multi(planes, r2d, c2d, miss, anchors=warp_gather.DUAL),
            lambda: warp_gather.warp_gather_batched_multi_plain(planes, r2d, c2d, miss, anchors=warp_gather.DUAL),
        ),
    }
    replaces = {
        "warp_gather_batched": "rgbd360_tpu/ops/warp_gather.py:254",
        "warp_gather_batched_multi": "rgbd360_tpu/ops/warp_gather.py:363",
    }
    kernels = []
    for name, (kernel_fn, plain_fn) in timing.items():
        # in turns: kernel, plain, plain, kernel
        k1, p1, p2, k2 = (cuda_ms(fn, TIMED_GATHERS) for fn in (kernel_fn, plain_fn, plain_fn, kernel_fn))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"[{card}] {name} at L0 ({BATCH}, 320, 8, 1920): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        kernels.append({
            "name": name, "route": "cuda", "source": "rgbd360_torch/csrc/warp_gather.cu",
            "replaces": replaces[name], "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms,
        })

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
