"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main paths through the entry points a user calls — dense
spherical photo+depth pair registration of the bundled golden pair
(tests/golden/pair_1_10.npz) at 1920x320, 5 pyramid levels, PHOTO_DEPTH,
batch 8, the odometry app over raw 8-sensor captures (load, undistort,
stitch, planes, register), the registration methods (the 8-camera pinhole
registration among them), the two SLAM apps and the batched sphere-graph
registration over a 40-frame loop, live capture, the MRPT rawlog loader,
the live map viewer and the pair mesh — and checks them end to end:

  1. a CUDA device is present; print the card's name and power limit;
  2. build the CUDA kernels from rgbd360_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path (L0, L1, L2; batch 8; real warps, a seam-
     straddling yaw and a two-band parallax case; every row policy and
     anchor set, and the single-buffer pass): out (as int32 bits) and mask
     must be identical;
  4. parallel.batch.align_batch at batch 8: every pair passes
     bench.sanity_check(kernel_path=True), the 8 identical pairs agree, and
     the kernel launch counts of that run equal the windowed sweeps it ran
     plus one dual-anchored pass; then the same on the single-buffer route
     (warp_gather.PIPELINE_KERNEL = False): its kernel carries every
     windowed sweep;
  5. the RegisterPhotoICP facade on one pair;
  5b. dense odometry (apps/odometry.py) over a synthetic dataset
     (tools/synthetic_rig.py: the construction-spec rig, seeded CLAMS
     models, 6 room captures 6 deg and ~8.4 cm apart; here its first 3) on
     the card, once on the default route and once on the single-buffer
     route: both pairs accepted within the ground-truth bound, the L0-L2
     sweeps carried by the route's kernel, the panorama stitched on the
     card equal to the CPU stitch but for at most 0.01% of its pixels, and
     the per-frame build and align times;
  5c. the plane layer on the card against the port's CPU planes on frame 1
     of that dataset: the segment-stage labels equal, the refined labels'
     differing share within LABEL_DIFF_LIMIT and every differing pixel
     explained (refine_differences), the plane count equal, normals, d and
     hull areas within their limits, for need_inliers True and False; and a
     lower-precision control (the card with TF32 matmuls) that the label
     gate must reject;
  5d. the odometry app with --with-planes on the card (the default route,
     planes_pipeline's worker thread fitting each frame's planes) over all
     6 frames: all 5 pairs accepted within the ground-truth bound, as many
     successful PbMap registrations as the port's planes give on the CPU
     (and at least one), the plane count of each frame on the card and on
     the CPU, the L0-L2 sweeps carried by warp_gather_batched, and per
     frame the synchronised times of the frame's device program (undistort,
     stitch and plane statistics), the collect, the host fit, the PbMap
     registration and the align;
  5e. the SLAM loop: first the plane refinement's growth kernel
     (csrc/planes_refine.cu) on loop frame 8 at the sensor program's shape
     (8 x 120 x 160; 138 rounds on its slowest sensor): labels and each
     sensor's rounds equal to the plain loop's on the card. Then
     SphereGraphSLAM (apps/sphere_graph_slam.py) on the
     card over a 40-frame loop of the room (radius 1.1 m, 9 deg and ~17 cm
     per step, ~6.9 m of trajectory): every frame's refinement one kernel
     launch and no plain loop (planes_seg.REFINE), every frame tracked or relocalized, at
     least one loop closure accepted and the graph optimized, the sweeps
     carried by their kernels (the full-coverage sweeps of the loop
     closer's refinements by the FULL form of warp_gather_batched_multi),
     at least one refinement through _refine_batch with >= 2 survivors (the
     last keyframe searched once more with its trajectory gap raised, when
     the loop's own closures refine one survivor each), each true closure
     (PbMap seed near the ground truth) within max(LC_GT_T, LC_GT_REL x
     baseline) and LC_GT_ROT_DEG of the ground truth, each false one set
     aside by the robust pose graph, each batched refinement within
     LC_SEQ_T of the facade's sequential refinement from the same seed, the
     optimized trajectory's ATE at most the raw one's plus 5 mm, and the
     relocalizer (its prefilter on the card) placing a loop frame on the
     finished map; ms per frame (median and p90 after frame 5) and the
     per-stage medians;
  5f. KFsphere_SLAM (apps/kf_sphere_slam.py) over the same loop, with
     speculative_align on and off in alternating runs: keyframes selected,
     loop closures, speculative aligns dispatched / consumed / wasted, ms per
     frame; the runs must agree;
  5g. MethodsRegisterRGBD360 (apps/methods_register.py) on frames 1->2 and
     1->3 of the 6-frame dataset on the card: the app as a user runs it
     (pair 1->2), then each of its five methods on its own (PbMap, dense
     sphere, dense sphere Occ1, point-to-plane ICP, the 8-camera robot-frame
     dense registration): every pose within the method's ground-truth bound
     (METHOD_GT, from the port's CPU run), the 8-camera and ICP poses within
     METHOD_CPU_T / METHOD_CPU_DEG of the port's CPU run, the Occ1 align's
     windowed sweeps carried by warp_gather_batched and its exact-final by
     one FULL launch of warp_gather_batched_multi, each method's
     synchronised ms;
  5h. RegisterGraphSphere (apps/register_graph_sphere.py) over the first 16
     frames of the 40-frame loop, batch 8: the pairs selected (chain and
     loop closure), every frame in one connected graph, the optimized
     trajectory's ATE at most the chained one's plus 5 mm, the partition,
     ms per align_batch chunk and pairs/s, the sweeps carried by their
     kernels;
  5i. the calibration suite on 6 captures ray-cast through a perturbed rig
     (tools/synthetic_rig.py::perturbed_rig(0): sensors 1-7 turned by 1 deg
     and shifted by N(0, 5 mm)) with a calibration root of construction
     specs, each app on the card as a user runs it: get_control_planes,
     pair_calibrator (--planes and --dataset, pair 1-2), calibrate_rig,
     online_calibration (3 frames), eval_calibration (4 frames, 3 dense
     aligns), visualize_calibration (frame 1). Against the port's CPU run:
     the per-frame control-plane counts equal, each ring pair's relative
     pose within CALIB_CPU_DEG / CALIB_CPU_T, eval_calibration's printout
     equal but for avScoreFitness, within FITNESS_LIMIT; each relative
     rotation closer to the truth than the construction specs and within
     CALIB_TRUTH_DEG (the translation error printed, not gated); the aligns'
     windowed sweeps carried by warp_gather_batched and one DUAL per align;
     per-frame build, planes and gather ms, the solve's and each align's;
  5j. load_stereo --planes on the room ray-cast as a 1024 x 180 stereo
     panorama on the card, held to the port's CPU run (stereo_parity: the
     segment-stage labels equal, the refined labels within LABEL_DIFF_LIMIT
     with each pixel explained, the same planes), the stereo device
     program's warm ms; tof_calibrator --demo on the card, its estimate
     within 1e-5 of the CPU's and its ground-truth error no worse than the
     JAX demo's;
  5k. live capture: the grabber app (apps/grabber.py --replay) copies the
     6-frame dataset, every .bin byte-equal to its source; the online
     odometry app (apps/online_odometry.py) on the card over the copy:
     every pair within the ground-truth bound, its first 3 poses equal to
     5b's odometry app's within ONLINE_ODOMETRY_T, the L0-L2 sweeps carried
     by warp_gather_batched and each exact-final by one DUAL launch, ms per
     frame; then --synthetic 3;
  5l. an MRPT rawlog of RAWLOG_FRAMES frames (4 sensors of 320 x 240 ray-
     cast in the room, u8 BGR raw CImage and f32 metres, and a LASER scan
     per frame the loader skips), written with the port's writer
     (tools/synthetic_rig.write_rawlog_sequence), loaded by
     apps/load_rawlog.py on the card and on the CPU in its images, cloud
     and save modes: the panoramas equal but for STITCH_DIFF_LIMIT of their
     pixels (5b's rule), the undistorted sensor clouds within
     RAWLOG_CLOUD_T, the saved planes within 5c's plane limits, ms per
     frame;
  the live map viewer: kf_sphere_slam with --live-view --live-port 0 over
     the first LIVE_FRAMES frames of the loop, live.json fetched over
     127.0.0.1 while the app runs and read after it: one trajectory entry
     per keyframe of the map;
  5m. the pair mesh (parallel/mesh.py): align_batch_sharded over
     make_mesh() on the golden pair at batch 8, every field bit-equal to
     phase 4's align_batch and its sweeps carried by the kernels; the dry
     run (parallel/dryrun.py) over [cuda:0, cuda:0], two shards of 4 pairs
     in a thread each: every leg bit-equal to its unsplit call, the launches
     counted across both threads equal to the sweeps, the loop-closure leg
     on the FULL form, the sharded prefilter equal to the unsplit one; the
     ms per batch of the split against the unsplit call (a record); the
     distinct cards each mesh spanned;
  6. timing with CUDA events: warm align throughput on the default
     (windowed kernel) and the exact route, in alternating rounds, and each
     kernel beside its plain version at the L0 shape (the multi-anchor pass
     with both anchor sets), with its bound: the bytes it must move (inputs
     read once, outputs written once) at the H100 SXM's 3.35 TB/s; a gather
     does no arithmetic to bound it. The growth kernel was timed in 5e,
     beside the plain loop, with the same byte bound (its rounds, not its
     bytes, set its time); its launches are counted in every path, and
     each path that builds planes on the card (5c, 5d, 5e, 5f, 5j) must
     have launched it.

Any failed check raises, and the script exits non-zero. The last line of
its output is the JSON status line. Run from the repository root:

    python3 chip_smoke.py
"""

import collections
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from rgbd360_torch.device import require_cuda  # noqa: E402

BATCH = 8
N_LEVELS = 5
TIMED_ALIGNS = 3
ROUTE_ROUNDS = 4  # cut from 10 and 6 to keep the command's time with the SLAM phases
TIMED_GATHERS = 20
ODOMETRY_FRAMES = 6  # the --with-planes phase
DENSE_ODOMETRY_FRAMES = 3  # the dense phase, on both routes (cut from 4, as ROUTE_ROUNDS)
STITCH_DIFF_LIMIT = 1e-4  # share of panorama pixels: f32 sin/cos and truncation
# the plane layer, card vs CPU on frame 1: the segment-stage labels must be
# equal, and every refined label that differs must be explained by
# refine_differences' rule. On an H100 the refined labels differed at 0% and
# 0.0977% of the pixels (before and after the stably ordered per-label
# sums); the same card with TF32 matmuls differed at 0.226% (and in 47
# segment-stage labels), and with atomic per-label sums at 0.170%.
LABEL_DIFF_LIMIT = 1.5e-3  # share of the 8 x 120 x 160 refined label pixels
LINE_LIKE_GAP = 1e-4  # eigengap / largest eigenvalue below which a region is a line
# the planes themselves: the CPU tests' tolerances, port against JAX
PLANE_NORMAL_LIMIT = 1e-4
PLANE_D_LIMIT = 1e-3  # metres
PLANE_AREA_LIMIT = 0.01  # relative
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# the SLAM loop (5e, 5f): tools/make_synthetic_sequence.py's 40-frame loop,
# one loop of radius 1.1 m, 9 deg and ~17 cm per step
SLAM_FRAMES = 40
SLAM_LOOPS = 1.0
SLAM_RADIUS = 1.1
KF_SLAM_RUNS = 4  # speculation on, off, off, on
# loop closures. A true closure (its PbMap seed within LC_GT_T and
# LC_GT_ROT_DEG of the ground truth) must refine to within the larger of
# LC_GT_T and LC_GT_REL of its baseline, and LC_GT_ROT_DEG. The dense
# refinement's error grows with the baseline: on the CPU, the windowed
# route (the card's gather, plain) gave 4.6% of a 2.1 m baseline (95 mm from
# a seed 0.7 mm off), the exact route 72 mm at 2.1 m, in both packages;
# tests/test_loop_closure.py's 8 cm is for a 0.27 m baseline. A false
# closure (a wrong plane assignment that passes the reference's gates:
# measured 3 of 55, seeds 2.1-2.2 m off) must be set aside by the robust
# pose graph. A batched refinement must equal the facade's sequential
# refinement of the same pair from the same seed within LC_SEQ_T.
LC_GT_T = 0.08  # metres
LC_GT_REL = 0.05  # of the baseline
LC_GT_ROT_DEG = 2.0
LC_OUTLIER_WEIGHT = 1e-3  # DCS weight of the robust pose graph
LC_SEQ_T = 0.005  # metres
# methods_register (5g), per method: the bound (metres, degrees) of its pose
# against the ground truth on pairs 1->2 and 1->3 of the 6-frame dataset,
# from the port's CPU run (the exact gather; the worst of the two pairs
# beside each). The card's dense sphere aligns take the windowed route.
METHOD_GT = {
    "PbMap (PLANAR_3DoF)": (0.002, 0.2),  # CPU 0.936 mm, 0.0773 deg
    "Dense Photo+Depth": (0.010, 0.5),  # CPU 6.471 mm, 0.3028 deg
    "Dense Photo+Depth Occ1": (0.012, 0.5),  # CPU 7.817 mm, 0.3261 deg
    "Point-to-plane ICP": (0.003, 0.2),  # the nearest-pixel floor: CPU 1.049 mm, 0.1060 deg
    "Dense 8-camera (robot)": (0.001, 0.1),  # CPU 0.325 mm, 0.0254 deg
}
METHOD_CPU_T = 0.001  # metres: the 8-camera and ICP poses, card vs CPU
METHOD_CPU_DEG = 0.05
GRAPH_FRAMES = 16  # register_graph_sphere's --max-frames default (5h)
GRAPH_BATCH = 8
# the calibration suite (5i): 6 captures through tools/synthetic_rig.py's
# perturbed_rig(0) (sensors 1-7 turned by 1 deg, shifted by N(0, 5 mm)),
# the calibration root of construction specs
CALIB_FRAMES = 6
CALIB_ONLINE_FRAMES = 3
CALIB_EVAL_FRAMES = 4  # 3 dense aligns
CALIB_TRUTH_DEG = 0.6  # every adjacent relative rotation against the truth
# card vs CPU, each adjacent relative pose of calibrate_rig's result: the
# control planes' offsets move by up to ~1e-4 m between two f32 fits
# (tests/test_torch_calibration.py), and the translation solve, ill-
# conditioned on a box room (ROADMAP queue 3), amplifies them. On an H100
# the card's rig sat within 5e-5 deg and 0.0051 mm of the CPU's.
CALIB_CPU_DEG = 0.01
CALIB_CPU_T = 0.001  # metres
# eval_calibration's avScoreFitness, card vs CPU: the windowed route against
# the CPU's exact one (load_sequence's avDepth tolerance; an H100 read 0.0866
# against the CPU's 0.0865)
FITNESS_LIMIT = 1.5e-3
# the stereo frame (5j): the room ray-cast at the derived full size
STEREO_TIMED = 10
# tof_calibrator --demo: the JAX app's printed ground-truth error (|dR|, |dt|)
TOF_DEMO_GT = (2.51e-5, 3.37e-4)
# live capture (5k): the online app's poses against the odometry app's (5b);
# both run the same per-frame program on the same captures
ONLINE_ODOMETRY_T = 1e-6
# the MRPT rawlog (5l): frames of 4 observations; the undistorted sensor
# clouds card vs CPU (tests/test_torch_rawlog.py: the port's CPU cloud is
# within 1.2e-6 m of JAX's; the card's bilateral weights may round apart)
RAWLOG_FRAMES = 3
RAWLOG_CLOUD_T = 1e-4  # metres
MESH_ROUNDS = 2  # 5m: split against unsplit, alternating
LIVE_FRAMES = 8  # the live viewer run: the first frames of the 40-frame loop


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


def reset_kernel_counts() -> None:
    """Zero the launch counts of every hand-written kernel: the gathers'
    (warp_gather.LAUNCHES) and the plane refinement's (planes_seg.REFINE)."""
    from rgbd360_torch.ops import planes_seg, warp_gather
    from rgbd360_torch.utils import timing

    warp_gather.reset_launch_counts()
    timing.reset_counts(planes_seg.REFINE)


def kernel_launches() -> dict:
    """Each hand-written kernel's launches since reset_kernel_counts()."""
    from rgbd360_torch.ops import planes_seg, warp_gather

    return {**warp_gather.LAUNCHES, "refine_grow": planes_seg.REFINE["kernel"]}


def _stage_ms(text: str, name: str) -> list:
    return [float(ms) for ms in re.findall(rf"^{re.escape(name)} took ([0-9.]+) ms$", text, re.M)]


def odometry_phase(dev, card, calib_root, seq, gt) -> tuple:
    """Phase 5b, over the first DENSE_ODOMETRY_FRAMES frames of ``seq``.
    Returns the launch counts of each route's run and the default route's
    trajectory."""
    from rgbd360_torch.apps import odometry
    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.io.calib import Calib360
    from rgbd360_torch.ops import photoicp, warp_gather
    from rgbd360_torch.utils import timing
    from tools import synthetic_rig as rig

    build_stages = ("Frame360.loadFrame", "Frame360.undistort", "Frame360.stitchSphericalImage")
    gt = gt[:DENSE_ODOMETRY_FRAMES]
    with tempfile.TemporaryDirectory() as tmp:
        short = os.path.join(tmp, "seq")
        os.mkdir(short)
        for n in range(1, DENSE_ODOMETRY_FRAMES + 1):
            os.symlink(os.path.join(seq, f"sphere_images_{n}.bin"), os.path.join(short, f"sphere_images_{n}.bin"))
        # the panorama stitched on the card against the port's CPU stitch
        calib = Calib360.load(calib_root)
        frame_path = os.path.join(seq, "sphere_images_1.bin")
        on_card = Frame360(calib, 1, dev).build(frame_path)
        on_cpu = Frame360(calib, 1, "cpu").build(frame_path)
        differ = ((on_card.sphere_rgb.cpu() != on_cpu.sphere_rgb).any(-1)
                  | (on_card.sphere_depth_mm.cpu() != on_cpu.sphere_depth_mm))
        n_differ = int(differ.sum())
        print(f"stitch of frame 1, card vs CPU: {n_differ} of {differ.numel()} pixels differ "
              f"(limit {int(STITCH_DIFF_LIMIT * differ.numel())})", flush=True)
        if n_differ > STITCH_DIFF_LIMIT * differ.numel():
            raise AssertionError(f"the card's stitch differs from the CPU's at {n_differ} pixels")

        route_launches, route_traj = {}, {}
        for route, pipelined in (("default", True), ("single-buffer", False)):
            out = os.path.join(tmp, f"out_{route}")
            buf = io.StringIO()
            try:
                warp_gather.PIPELINE_KERNEL = pipelined
                timing.stage_timing(True)
                reset_kernel_counts()
                photoicp.reset_sweep_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = odometry.main([short, "--calib-root", calib_root, "--out", out, "--device", str(dev)])
                torch.cuda.synchronize()
                app_ms = (time.perf_counter() - t0) * 1000.0
                launches, sweeps = kernel_launches(), dict(photoicp.SWEEPS)
            finally:
                warp_gather.PIPELINE_KERNEL = True
                timing.stage_timing(False)
            text = buf.getvalue()
            print("".join(line + "\n" for line in text.splitlines() if line.startswith(("frame ", "trajectory"))), end="")
            traj = np.loadtxt(os.path.join(out, "trajectory.txt")).reshape(-1, 4, 4)
            errs = rig.relative_pose_errors(traj, gt)
            build = np.sum([_stage_ms(text, name) for name in build_stages], axis=0)
            align = np.array(_stage_ms(text, "Dense alignment 360"))
            print(f"[{card}] odometry {route} route: {len(traj) - 1} of {DENSE_ODOMETRY_FRAMES - 1} pairs accepted; "
                  f"error vs ground truth max {errs[:, 0].max() * 1000:.3f} mm, {errs[:, 1].max():.4f} deg "
                  f"(bound {rig.GT_T * 1000:.0f} mm, {rig.GT_ROT_DEG} deg); per-frame ms, synchronised: "
                  f"build (load + undistort + stitch) {np.round(build, 3).tolist()} median {np.median(build):.3f}, "
                  f"align {np.round(align, 3).tolist()} median {np.median(align):.3f}; "
                  f"the whole app {app_ms:.1f} ms", flush=True)
            print(f"launches {launches} sweeps {sweeps}", flush=True)
            if rc != 0 or len(traj) != DENSE_ODOMETRY_FRAMES:
                raise AssertionError(f"odometry {route}: rc {rc}, {len(traj) - 1} pairs accepted")
            if not ((errs[:, 0] < rig.GT_T).all() and (errs[:, 1] < rig.GT_ROT_DEG).all()):
                raise AssertionError(f"odometry {route}: relative poses outside the ground-truth bound: {errs}")
            kernel = "warp_gather_batched" if pipelined else "warp_gather_single"
            other = "warp_gather_single" if pipelined else "warp_gather_batched"
            if not (launches[kernel] == sweeps["windowed"] > 0 and launches[other] == 0
                    and launches["warp_gather_batched_multi"] == sweeps["exact_final_dual"] == DENSE_ODOMETRY_FRAMES - 1):
                raise AssertionError(f"odometry {route}: the sweeps did not run through {kernel}: {launches} vs {sweeps}")
            route_launches[route] = launches
            route_traj[route] = traj
    return route_launches, route_traj["default"]


def planes_phase(dev, card, calib_root, seq) -> dict:
    """Phase 5c: the plane layer on the card against the port's CPU planes,
    and a lower-precision control that the label gate must reject. Returns
    the launch counts of the phase."""
    from rgbd360_torch.core import plane_extraction
    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.io.calib import Calib360

    calib = Calib360.load(calib_root)
    frame_path = os.path.join(seq, "sphere_images_1.bin")
    reset_kernel_counts()
    on_card = Frame360(calib, 1, dev).build(frame_path)
    on_cpu = Frame360(calib, 1, "cpu").build(frame_path)

    def clouds(frame):
        xyz2, _r, _n, pre, lab = plane_extraction._sensor_clouds(frame.depth_undistorted_m, frame.rgb)
        return xyz2.cpu().numpy(), pre.cpu().numpy(), lab.cpu().numpy()

    xyz2, pre_cpu, lab_cpu = clouds(on_cpu)
    _x, pre_card, lab_card = clouds(on_card)
    try:
        # the control: the bilateral filter's matmuls in TF32, which the
        # package turns off
        torch.set_float32_matmul_precision("high")
        _x, pre_tf32, lab_tf32 = clouds(on_card)
    finally:
        torch.set_float32_matmul_precision("highest")

    def passes(name, pre, lab):
        pre_differ = int((pre != pre_cpu).sum())
        differ = lab != lab_cpu
        unexplained = refine_differences(xyz2, pre_cpu, lab, lab_cpu) if pre_differ == 0 else int(differ.sum())
        print(f"planes of frame 1, {name} vs CPU: segment-stage labels differ at {pre_differ} pixels; refined labels "
              f"at {int(differ.sum())} pixels = {differ.mean():.4%} (limit {LABEL_DIFF_LIMIT:.2%}), "
              f"{unexplained} of them unexplained by refine_differences' rule", flush=True)
        return pre_differ == 0 and differ.mean() <= LABEL_DIFF_LIMIT and unexplained == 0

    if not passes("card", pre_card, lab_card):
        raise AssertionError("the card's plane labels differ from the CPU's beyond the refinement's ill-posed cases")
    if passes("card with TF32 matmuls (control)", pre_tf32, lab_tf32):
        raise AssertionError("the label gate does not tell TF32 matmuls from full f32")
    for need_inliers in (True, False):
        card_pb, cpu_pb = on_card.get_planes(need_inliers), on_cpu.get_planes(need_inliers)
        if len(card_pb) != len(cpu_pb) or len(cpu_pb) == 0:
            raise AssertionError(f"need_inliers={need_inliers}: {len(card_pb)} planes on the card, {len(cpu_pb)} on the CPU")
        dn = max(float(np.abs(a.normal - b.normal).max()) for a, b in zip(card_pb.planes, cpu_pb.planes))
        dd = max(abs(a.d - b.d) for a, b in zip(card_pb.planes, cpu_pb.planes))
        da = max(abs(a.area_hull - b.area_hull) / b.area_hull for a, b in zip(card_pb.planes, cpu_pb.planes))
        print(f"[{card}] planes need_inliers={need_inliers}: {len(card_pb)} on the card = {len(cpu_pb)} on the CPU; "
              f"largest deviation: normal {dn:.3g} (limit {PLANE_NORMAL_LIMIT}), d {dd:.3g} m (limit {PLANE_D_LIMIT}), "
              f"hull area {da:.3g} relative (limit {PLANE_AREA_LIMIT})", flush=True)
        if dn > PLANE_NORMAL_LIMIT or dd > PLANE_D_LIMIT or da > PLANE_AREA_LIMIT:
            raise AssertionError(f"need_inliers={need_inliers}: the card's planes deviate from the CPU's")
    return kernel_launches()


def refine_differences(xyz2, pre, lab_a, lab_b) -> int:
    """How many of the pixels that two refinements of the same segment-stage
    labels ``pre`` label differently are unexplained. A pixel is explained
    when it is unlabeled before the refinement (so only the refinement
    decides it) and one of the two absorbs it into a line-like region: one
    whose segment-stage pixels have an f64 covariance with eigengap
    lambda2 - lambda3 < LINE_LIKE_GAP * lambda1. The f32 plane of such a
    region may have any normal across the line, chosen by rounding, so
    which pixels fit it within the distance limit is chosen by rounding
    too."""
    line_like = {}
    unexplained = 0
    for s, r, c in np.argwhere(lab_a != lab_b):
        regions = {int(lab_a[s, r, c]), int(lab_b[s, r, c])} - {-1}
        for region in regions - {k for _s, k in line_like if _s == s}:
            pts = xyz2[s][pre[s] == region].astype(np.float64)
            w = np.linalg.eigvalsh(np.cov(pts.T, bias=True))
            line_like[s, region] = bool(w[1] - w[0] < LINE_LIKE_GAP * w[2])
        if pre[s, r, c] != -1 or not any(line_like[s, k] for k in regions):
            unexplained += 1
    return unexplained


def with_planes_phase(dev, card, calib_root, seq, gt) -> dict:
    """Phase 5d: the odometry app with --with-planes on the card. Returns
    the launch counts of the run."""
    from rgbd360_torch.apps import odometry
    from rgbd360_torch.apps.common import default_matcher_config
    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.core.graph_optimizer import _log_se3
    from rgbd360_torch.core.matcher import PLANAR_3DOF
    from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360
    from rgbd360_torch.io.calib import Calib360
    from rgbd360_torch.ops import photoicp
    from rgbd360_torch.utils import timing
    from tools import synthetic_rig as rig

    # the port's PbMap registrations of the same pairs on the CPU
    calib = Calib360.load(calib_root)
    t0 = time.perf_counter()
    cpu_frames = [Frame360(calib, n, "cpu").build(os.path.join(seq, f"sphere_images_{n}.bin"))
                  for n in range(1, ODOMETRY_FRAMES + 1)]
    for f in cpu_frames:
        f.get_planes(need_inliers=False)
    registerer = RegisterRGBD360(default_matcher_config(calib_root))
    cpu_ok = sum(registerer.register_pbmap(a, b, 25, PLANAR_3DOF) for a, b in zip(cpu_frames, cpu_frames[1:]))
    print(f"PbMap registration on the CPU: {cpu_ok} of {ODOMETRY_FRAMES - 1} pairs "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        buf = io.StringIO()
        try:
            timing.stage_timing(True)
            reset_kernel_counts()
            photoicp.reset_sweep_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = odometry.main([seq, "--calib-root", calib_root, "--out", out, "--with-planes", "--device", str(dev)])
            torch.cuda.synchronize()
            app_ms = (time.perf_counter() - t0) * 1000.0
            launches, sweeps = kernel_launches(), dict(photoicp.SWEEPS)
        finally:
            timing.stage_timing(False)
        text = buf.getvalue()
        traj = np.loadtxt(os.path.join(out, "trajectory.txt")).reshape(-1, 4, 4)
    print("".join(line + "\n" for line in text.splitlines() if line.startswith(("frame ", "trajectory"))), end="")
    errs = rig.relative_pose_errors(traj, gt)
    card_ok = sum(" pbmap ok " in line for line in text.splitlines())
    pairs = re.findall(r" planes (\d+)/(\d+) pbmap ", text)
    card_planes = [int(pairs[0][0])] + [int(b) for _a, b in pairs] if pairs else []
    print(f"planes per frame: {card_planes} on the card, {[len(f.planes) for f in cpu_frames]} on the CPU", flush=True)
    times = {name: np.round(_stage_ms(text, stage_name), 3).tolist() for name, stage_name in (
        ("frame device program (undistort + stitch + plane statistics)", "Frame360.build_device_fused"),
        ("collect", "planes collect (sync)"),
        ("host fit", "planes host fit"), ("PbMap registration", "PbMap registration"),
        ("align", "Dense alignment 360"))}
    print(f"[{card}] odometry --with-planes: {len(traj) - 1} of {ODOMETRY_FRAMES - 1} pairs accepted; "
          f"PbMap registrations {card_ok} on the card, {cpu_ok} on the CPU; error vs ground truth max "
          f"{errs[:, 0].max() * 1000:.3f} mm, {errs[:, 1].max():.4f} deg; per-frame ms, synchronised: "
          + "; ".join(f"{k} {v} median {np.median(v):.3f}" for k, v in times.items())
          + f"; the whole app {app_ms:.1f} ms", flush=True)
    print(f"launches {launches} sweeps {sweeps}", flush=True)
    if rc != 0 or len(traj) != ODOMETRY_FRAMES:
        raise AssertionError(f"odometry --with-planes: rc {rc}, {len(traj) - 1} pairs accepted")
    if not ((errs[:, 0] < rig.GT_T).all() and (errs[:, 1] < rig.GT_ROT_DEG).all()):
        raise AssertionError(f"odometry --with-planes: relative poses outside the ground-truth bound: {errs}")
    if card_ok != cpu_ok or cpu_ok == 0:
        raise AssertionError(f"odometry --with-planes: {card_ok} PbMap registrations on the card, {cpu_ok} on the CPU")
    if not (launches["warp_gather_batched"] == sweeps["windowed"] > 0 and launches["warp_gather_single"] == 0
            and launches["warp_gather_batched_multi"] == sweeps["exact_final_dual"] == ODOMETRY_FRAMES - 1):
        raise AssertionError(f"odometry --with-planes: the sweeps did not run through the kernels: {launches} vs {sweeps}")
    return launches


def _frame_ms(text: str) -> list:
    """The wall time of each frame line of a SLAM app's output."""
    return [float(ms) for ms in re.findall(r"^frame \d+: .*\(([0-9.]+) ms\)$", text, re.M)]


def _stage_medians(text: str) -> dict:
    names = sorted(set(re.findall(r"^(.+) took [0-9.]+ ms$", text, re.M)))
    return {name: round(float(np.median(_stage_ms(text, name))), 3) for name in names}


def _rot_deg(pose_a: np.ndarray, pose_b: np.ndarray) -> float:
    """The angle of R_a^T R_b in degrees, from both its sine and cosine:
    arccos alone reads 0.02-0.04 deg between two equal f32 rotations."""
    r = pose_a[:3, :3].astype(np.float64).T @ pose_b[:3, :3].astype(np.float64)
    sin = np.linalg.norm([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(sin, (np.trace(r) - 1.0) / 2.0)))


REFINE_FRAME = 8  # loop frame 8 (capture 7): the slowest sensor's refinement runs 138 rounds
TIMED_REFINES = 50


def refine_phase(dev, card, calib_root, seq) -> dict:
    """Phase 5e, first part: the plane refinement's growth loop of loop
    frame REFINE_FRAME as the frame program makes its inputs, the kernel
    against the plain loop on the card (labels; each sensor's rounds), then
    both timed, in turns. Returns the kernel's record for the kernels line."""
    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.io.calib import Calib360
    from rgbd360_torch.ops import planes_seg

    frame = Frame360(Calib360.load(calib_root), REFINE_FRAME, dev)
    frame.load_frame(os.path.join(seq, f"sphere_images_{REFINE_FRAME}.bin"))
    grow, seen = planes_seg.grow_labels, []
    try:
        planes_seg.grow_labels = lambda *a: seen.append(a) or grow(*a)
        frame.build_device_fused()
    finally:
        planes_seg.grow_labels = grow
    args = seen[-1]
    got, rounds = planes_seg.grow_labels(*args)
    want, want_rounds = planes_seg.grow_labels_plain(*args)
    torch.cuda.synchronize()
    per_sensor = rounds.cpu().tolist()
    alone = [planes_seg.grow_labels_plain(*[a[s:s + 1].contiguous() for a in args[:6]], *args[6:])[1]
             for s in range(len(per_sensor))]
    same = bool(torch.equal(got, want))
    max_abs_err = int((got.long() - want.long()).abs().max())
    print(f"refine_grow kernel vs plain loop, loop frame {REFINE_FRAME} {tuple(got.shape)}: labels equal {same} "
          f"(max_abs_err {max_abs_err}); "
          f"rounds per sensor {per_sensor}, plain {alone} (batch {want_rounds})", flush=True)
    if not (same and per_sensor == alone and max(per_sensor) == want_rounds):
        raise AssertionError("the growth kernel disagrees with the plain loop")
    kernel_fn = lambda: planes_seg.grow_labels(*args)
    plain_fn = lambda: planes_seg.grow_labels_plain(*args)
    n_plain = 3
    k1, p1, p2, k2 = (cuda_ms(fn, n) for fn, n in ((kernel_fn, TIMED_REFINES), (plain_fn, n_plain),
                                                    (plain_fn, n_plain), (kernel_fn, TIMED_REFINES)))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    bound_ms = gather_bound_ms(*args[:6], got)
    print(f"[{card}] refine_grow at {tuple(got.shape)}, {max(per_sensor)} rounds: kernel {ms:.4f} ms "
          f"({ms / max(per_sensor) * 1000:.2f} us a round), plain loop {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by "
          f"bytes ({bound_ms / ms:.2%} of it reached), 1 launch a call", flush=True)
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "rounds": per_sensor}


def slam_phase(dev, card, calib_root, seq, gt) -> dict:
    """Phase 5e: SphereGraphSLAM over the SLAM_FRAMES-frame loop on the
    card, its loop closures held to the ground truth and to the facade's
    sequential refinement, and the relocalizer on the finished map. Returns
    the launch counts of the app's run."""
    from rgbd360_torch.apps import sphere_graph_slam
    from rgbd360_torch.apps.common import default_matcher_config
    from rgbd360_torch.core import loop_closure
    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.core.graph_optimizer import _log_se3
    from rgbd360_torch.core.matcher import PLANAR_3DOF
    from rgbd360_torch.core.register_photoicp import RegisterPhotoICP
    from rgbd360_torch.core.relocalizer import Relocalizer360
    from rgbd360_torch.io.boost_archive import write_frame360_bin
    from rgbd360_torch.io.calib import Calib360
    from rgbd360_torch.ops import photoicp, planes_seg
    from rgbd360_torch.utils import timing
    from tools import synthetic_rig as rig

    def kernels_carried(what, launches, sweeps):
        """Every windowed sweep launched its kernel once: single-anchor
        sweeps warp_gather_batched, full-coverage sweeps and dual exact-final
        passes warp_gather_batched_multi."""
        print(f"{what}: launches {launches} sweeps {sweeps}", flush=True)
        if not (launches["warp_gather_batched"] == sweeps["windowed"] and launches["warp_gather_single"] == 0
                and launches["warp_gather_batched_multi"] == sweeps["full_coverage"] + sweeps["exact_final_dual"]
                and sweeps["full_coverage"] > 0):
            raise AssertionError(f"{what}: the sweeps did not run through the kernels: {launches} vs {sweeps}")

    buf = io.StringIO()
    try:
        timing.stage_timing(True)
        reset_kernel_counts()
        photoicp.reset_sweep_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            session = sphere_graph_slam.run([seq, "--calib-root", calib_root, "--device", str(dev)])
        torch.cuda.synchronize()
        app_ms = (time.perf_counter() - t0) * 1000.0
        launches, sweeps = kernel_launches(), dict(photoicp.SWEEPS)
        refine = dict(planes_seg.REFINE)
    finally:
        timing.stage_timing(False)
    text = buf.getvalue()
    lines = [line for line in text.splitlines() if line.startswith("frame ")]
    print("".join(line + "\n" for line in lines) + text.splitlines()[-1], flush=True)
    kernels_carried("SphereGraphSLAM", launches, sweeps)
    print(f"SphereGraphSLAM planes_seg.REFINE: {refine}", flush=True)
    if refine["kernel"] < SLAM_FRAMES or refine["host_loop"] != 0:
        raise AssertionError(f"SphereGraphSLAM: the refinement did not run through its kernel: {refine}")
    world, lc = session.world, session.loop_closer
    placed = sum((" tracked vs " in line or "RELOCALIZED" in line or "first keyframe" in line) for line in lines)
    if len(lines) != SLAM_FRAMES or placed != SLAM_FRAMES or len(world) != SLAM_FRAMES:
        raise AssertionError(f"SphereGraphSLAM: {placed} of {len(lines)} frames tracked or relocalized")
    if session.n_loop_closures < 1 or "graph optimized" not in text:
        raise AssertionError("SphereGraphSLAM: no loop closure accepted")
    frame_ms = np.array(_frame_ms(text))
    steady = frame_ms[5:]
    print(f"[{card}] SphereGraphSLAM, {SLAM_FRAMES}-frame loop: {len(world)} keyframes, {len(world.areas)} areas, "
          f"{session.n_loop_closures} loop closures (pairs per refinement {lc.refinements}); ms per frame after frame 5: median {np.median(steady):.3f}, "
          f"p90 {np.percentile(steady, 90):.3f} (all frames {np.round(frame_ms, 3).tolist()}); the whole app "
          f"{app_ms:.1f} ms", flush=True)
    print(f"[{card}] SphereGraphSLAM stage medians (ms, synchronised): {json.dumps(_stage_medians(text))}", flush=True)
    raw_ate = rig.absolute_trajectory_error(world.trajectory_poses, gt)
    opt_ate = rig.absolute_trajectory_error(world.optimized_poses, gt)
    print(f"[{card}] SphereGraphSLAM ATE: raw {raw_ate * 1000:.3f} mm, optimized {opt_ate * 1000:.3f} mm", flush=True)
    if opt_ate > raw_ate + 0.005:
        raise AssertionError(f"optimized ATE {opt_ate} vs raw {raw_ate}")

    # a batched refinement of >= 2 survivors: the loop's own closures, or the
    # last keyframe once more with its trajectory gap raised (as
    # tests/test_loop_closure.py:141-182 does), so that every keyframe of its
    # area is a candidate
    if max(lc.refinements, default=0) >= 2:
        print("batched refinement: run by the loop's own closures", flush=True)
    else:
        last = len(world) - 1
        world.trajectory_increments[last] += 2 * loop_closure.MIN_TRAJECTORY_GAP
        reset_kernel_counts()
        photoicp.reset_sweep_counts()
        t0 = time.perf_counter()
        accepted = lc.process_new_keyframe(last)
        torch.cuda.synchronize()
        extra_ms = (time.perf_counter() - t0) * 1000.0
        extra_launches, extra_sweeps = kernel_launches(), dict(photoicp.SWEEPS)
        print(f"batched refinement: the loop's closures refined one survivor each; keyframe {last} once more with "
              f"its trajectory gap raised: pairs per refinement {lc.refinements}, {accepted} accepted, "
              f"{extra_ms:.1f} ms", flush=True)
        kernels_carried("the raised-gap search", extra_launches, extra_sweeps)
        if accepted:  # as the app does after draining new closures
            session.optimizer.optimize_graph()
    if max(lc.refinements, default=0) < 2:
        raise AssertionError(f"no refinement went through _refine_batch with >= 2 survivors: {lc.refinements}")

    # each accepted closure: a true one (its PbMap seed within the limits of
    # the ground truth) refines to within max(LC_GT_T, LC_GT_REL * baseline)
    # and LC_GT_ROT_DEG of it; a false one (a wrong plane assignment the
    # reference's gates let through) must be set aside by the robust pose
    # graph (weight < LC_OUTLIER_WEIGHT at its optimum). Each closure refined
    # in a batch against the card's sequential facade refinement of the same
    # pair from the same seed (a single survivor's refinement is that call)
    truth = np.linalg.inv(gt[0]) @ gt
    opt = session.optimizer
    chi2 = np.array([(lambda r: r @ e.info @ r)(_log_se3(np.linalg.inv(e.z) @ np.linalg.inv(opt.vertices[e.i])
                                                          @ opt.vertices[e.j])) for e in opt.edges])
    weight = {(e.i, e.j): w for e, w in zip(opt.edges, opt._robust_weights(chi2))}  # the later edge of a pair
    aligner = RegisterPhotoICP(5, device=dev)
    closures = []
    for cand, kf, batched in lc.accepted:
        rel = world.connection_kfs[kf][cand][0].astype(np.float64)
        true_rel = np.linalg.inv(truth[cand]) @ truth[kf]
        if not lc.registerer.register_pbmap(world.frames[cand], world.frames[kf], 25, PLANAR_3DOF):
            raise AssertionError(f"loop closure {cand}->{kf}: its PbMap registration failed on a re-run")
        pb = lc.registerer.get_pose().astype(np.float64)
        true = (np.linalg.norm(pb[:3, 3] - true_rel[:3, 3]) <= LC_GT_T and _rot_deg(pb, true_rel) <= LC_GT_ROT_DEG)
        seq_t = 0.0
        if batched:
            seed = lc.rot_offset @ pb @ np.linalg.inv(lc.rot_offset)
            aligner.set_target_frame(world.frames[cand].sphere_rgb, world.frames[cand].sphere_depth_mm)
            aligner.set_source_frame(world.frames[kf].sphere_rgb, world.frames[kf].sphere_depth_mm)
            aligner.align_frames360(seed.astype(np.float32), photoicp.PHOTO_DEPTH, full_coverage=True)
            seq_rel = np.linalg.inv(lc.rot_offset) @ aligner.get_optimal_pose().astype(np.float64) @ lc.rot_offset
            seq_t = np.linalg.norm(rel[:3, 3] - seq_rel[:3, 3])
        baseline = np.linalg.norm(true_rel[:3, 3])
        closures.append(dict(
            edge=(cand, kf), batched=batched, true=bool(true), baseline=baseline,
            t=np.linalg.norm(rel[:3, 3] - true_rel[:3, 3]), deg=_rot_deg(rel, true_rel), seq_t=seq_t,
            limit=max(LC_GT_T, LC_GT_REL * baseline), weight=float(weight[cand, kf]),
        ))
    true_ones = [c for c in closures if c["true"]]
    false_ones = [c for c in closures if not c["true"]]
    worst = lambda key, cs: max((c[key] for c in cs), default=0.0)
    print(f"[{card}] loop closures: {len(closures)} ({sum(c['batched'] for c in closures)} refined in batches); "
          f"{len(true_ones)} true: worst {worst('t', true_ones) * 1000:.1f} mm ({max((c['t'] / c['baseline'] for c in true_ones), default=0):.2%} "
          f"of the baseline) and {worst('deg', true_ones):.3f} deg from the ground truth, "
          f"{sum(c['t'] > LC_GT_T for c in true_ones)} beyond a flat {LC_GT_T * 1000:.0f} mm; {len(false_ones)} false: "
          + ", ".join(f"{c['edge'][0]}->{c['edge'][1]} {c['t']:.3f} m {c['deg']:.2f} deg weight {c['weight']:.2g}"
                      for c in false_ones)
          + f"; batched vs sequential facade refinement worst {worst('seq_t', closures) * 1000:.4f} mm "
          f"(limit {LC_SEQ_T * 1000:.0f} mm)", flush=True)
    bad = [c for c in closures if c["seq_t"] > LC_SEQ_T or (c["true"] and (c["t"] > c["limit"] or c["deg"] > LC_GT_ROT_DEG))
           or (not c["true"] and c["weight"] >= LC_OUTLIER_WEIGHT)]
    if bad or not true_ones:
        raise AssertionError(f"loop closures outside the limits: {bad}")

    # the relocalizer: a frame between loop frames 1 and 2 against the whole
    # map, the prefilter on the card
    calib = Calib360.load(calib_root)
    with tempfile.TemporaryDirectory() as tmp:
        pose = rig.loop_pose(2.0 * np.pi * 0.5 / SLAM_FRAMES, SLAM_RADIUS)
        path = os.path.join(tmp, "sphere_images_1.bin")
        write_frame360_bin(path, rig.room_capture(pose, calib.Rt))
        frame = Frame360(calib, 1, dev).build(path)
    frame.get_planes(need_inliers=False)
    t0 = time.perf_counter()
    hit = Relocalizer360(world, default_matcher_config(calib_root), device=dev).relocalize(frame)
    reloc_ms = (time.perf_counter() - t0) * 1000.0
    if hit is None:
        raise AssertionError("the relocalizer found no keyframe for a loop frame")
    kf_id, rel_pb, _info = hit
    true_rel = np.linalg.inv(truth[kf_id]) @ np.linalg.inv(gt[0]) @ pose
    print(f"[{card}] relocalized a loop frame against keyframe {kf_id} of {len(world)} in {reloc_ms:.1f} ms; PbMap pose "
          f"{np.linalg.norm(rel_pb[:3, 3] - true_rel[:3, 3]) * 1000:.1f} mm, {_rot_deg(rel_pb, true_rel):.3f} deg "
          f"from the ground truth", flush=True)
    return launches


def kf_slam_phase(dev, card, calib_root, seq) -> dict:
    """Phase 5f: KFsphere_SLAM over the same loop, with speculative_align on
    and off in alternating runs. Returns the launch counts of the first run
    (speculation on)."""
    from rgbd360_torch.apps import kf_sphere_slam
    from rgbd360_torch.ops import photoicp

    runs, first = [], None
    for k, spec in enumerate((True, False, False, True)[:KF_SLAM_RUNS]):
        buf = io.StringIO()
        reset_kernel_counts()
        photoicp.reset_sweep_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            slam = kf_sphere_slam.run([seq, "--calib-root", calib_root, "--device", str(dev)]
                                      + ([] if spec else ["--no-speculative-align"]))
        torch.cuda.synchronize()
        app_ms = (time.perf_counter() - t0) * 1000.0
        text = buf.getvalue()
        kinds = re.findall(r"^frame \d+: (\w+)", text, re.M)
        frame_ms = np.array(_frame_ms(text))
        runs.append((spec, kinds, [np.asarray(p) for p in slam.world.trajectory_poses], frame_ms))
        if k == 0:
            first = kernel_launches()
            print(text.splitlines()[-1], flush=True)
        counts = slam.speculative_counts
        print(f"[{card}] KFsphere_SLAM run {k + 1}, speculative_align {'on' if spec else 'off'}: "
              f"{len(slam.world)} keyframes selected of {len(kinds)} frames, {slam.n_loop_closures} loop closures, "
              f"kinds {dict(collections.Counter(kinds))}; speculative aligns dispatched "
              f"{counts['dispatched']} consumed {counts['consumed']} wasted {counts['wasted']}; ms per frame after "
              f"frame 5: median {np.median(frame_ms[5:]):.3f}, p90 {np.percentile(frame_ms[5:], 90):.3f}; the whole "
              f"app {app_ms:.1f} ms", flush=True)
        if len(kinds) != SLAM_FRAMES or (spec and counts["dispatched"] != counts["consumed"] + counts["wasted"]):
            raise AssertionError(f"KFsphere_SLAM run {k + 1}: {len(kinds)} frames, counts {counts}")
    (_s, kinds0, traj0, _m), rest = runs[0], runs[1:]
    for spec, kinds, traj, _ms in rest:
        if kinds != kinds0 or not np.array_equal(np.stack(traj), np.stack(traj0)):
            raise AssertionError("KFsphere_SLAM: speculation changed the outcome")
    on = np.concatenate([ms[5:] for spec, _k, _t, ms in runs if spec])
    off = np.concatenate([ms[5:] for spec, _k, _t, ms in runs if not spec])
    print(f"[{card}] KFsphere_SLAM ms per frame after frame 5, {KF_SLAM_RUNS} alternating runs: speculative_align on "
          f"median {np.median(on):.3f}, off median {np.median(off):.3f}", flush=True)
    return first


def methods_phase(dev, card, calib_root, seq, gt) -> tuple:
    """Phase 5g. Returns the launch counts of the app's run (pair 1->2) and
    of its Occ1 align alone (pair 1->2)."""
    from rgbd360_torch.apps import methods_register
    from rgbd360_torch.apps.common import default_matcher_config
    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.io.calib import Calib360
    from rgbd360_torch.ops import photoicp, photoicp_pinhole

    path = lambda n: os.path.join(seq, f"sphere_images_{n}.bin")

    def reset():
        reset_kernel_counts()
        photoicp.reset_sweep_counts()
        photoicp_pinhole.reset_sweep_counts()

    buf = io.StringIO()
    reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        methods_register.run([path(1), path(2), "--calib-root", calib_root, "--device", str(dev)])
    torch.cuda.synchronize()
    app_ms = (time.perf_counter() - t0) * 1000.0
    app_launches, sweeps = kernel_launches(), dict(photoicp.SWEEPS)
    print(buf.getvalue().rstrip(), flush=True)
    print(f"[{card}] methods_register app, frames 1->2: {app_ms:.1f} ms (frame builds and planes included); "
          f"launches {app_launches} sweeps {sweeps}", flush=True)
    # the plain align: windowed sweeps + one DUAL exact-final; Occ1: windowed
    # sweeps + one FULL occluded exact-final
    if not (app_launches["warp_gather_batched"] == sweeps["windowed"] > 0 and app_launches["warp_gather_single"] == 0
            and sweeps["exact_final_dual"] == sweeps["full_coverage"] == 1
            and app_launches["warp_gather_batched_multi"] == 2):
        raise AssertionError(f"methods_register: the sweeps did not run through the kernels: {app_launches} vs {sweeps}")

    calib = Calib360.load(calib_root)
    cfg = default_matcher_config(calib_root)
    frames = {}
    for where in (dev, "cpu"):
        for n in (1, 2, 3):
            frames[where, n] = Frame360(calib, n, where).build(path(n))
            frames[where, n].get_planes()
    truth = np.linalg.inv(gt[0]) @ gt
    occ1_launches = None
    for j in (2, 3):
        on_cpu = dict(methods_register.methods(frames["cpu", 1], frames["cpu", j], cfg))
        for name, method in methods_register.methods(frames[dev, 1], frames[dev, j], cfg):
            reset()
            t0 = time.perf_counter()
            pose = method()
            ms = (time.perf_counter() - t0) * 1000.0
            launches, sweeps, pinhole = kernel_launches(), dict(photoicp.SWEEPS), dict(photoicp_pinhole.SWEEPS)
            if pose is None:
                raise AssertionError(f"methods_register 1->{j}: {name} failed on the card")
            err_t, err_deg = np.linalg.norm(pose[:3, 3] - truth[j - 1][:3, 3]), _rot_deg(pose, truth[j - 1])
            bound_t, bound_deg = METHOD_GT[name]
            line = (f"[{card}] methods_register 1->{j} {name}: {ms:.3f} ms synchronised; vs ground truth "
                    f"{err_t * 1000:.3f} mm {err_deg:.4f} deg (bound {bound_t * 1000:.0f} mm {bound_deg} deg)")
            if name == "Dense 8-camera (robot)":
                line += f"; pinhole sweeps {pinhole['sweeps']} (LM retries {pinhole['lm_retries']})"
            if name in ("Point-to-plane ICP", "Dense 8-camera (robot)"):
                cpu_pose = on_cpu[name]()
                dt, ddeg = np.linalg.norm(pose[:3, 3] - cpu_pose[:3, 3]), _rot_deg(pose, cpu_pose)
                line += f"; vs the CPU {dt * 1000:.4f} mm {ddeg:.5f} deg"
                if dt > METHOD_CPU_T or ddeg > METHOD_CPU_DEG:
                    raise AssertionError(f"methods_register 1->{j}: {name} on the card {dt} m, {ddeg} deg from the CPU")
            if name == "Dense Photo+Depth Occ1":
                line += f"; launches {launches} sweeps {sweeps}"
                if not (launches["warp_gather_batched"] == sweeps["windowed"] > 0 and launches["warp_gather_single"] == 0
                        and launches["warp_gather_batched_multi"] == sweeps["full_coverage"] == 1
                        and sweeps["exact_final_dual"] == 0):
                    raise AssertionError(f"Occ1 align: the sweeps did not run through the kernels: {launches} vs {sweeps}")
                if j == 2:
                    occ1_launches = launches
            print(line, flush=True)
            if err_t > bound_t or err_deg > bound_deg:
                raise AssertionError(f"methods_register 1->{j}: {name} outside its ground-truth bound")
    return app_launches, occ1_launches


def _quat_pose(values) -> np.ndarray:
    """4x4 from g2o's "tx ty tz qx qy qz qw"."""
    tx, ty, tz, x, y, z, w = values
    pose = np.eye(4)
    pose[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    pose[:3, 3] = tx, ty, tz
    return pose


def graph_phase(dev, card, calib_root, seq, gt) -> dict:
    """Phase 5h: register_graph_sphere over the first GRAPH_FRAMES frames of
    the loop. Returns the launch counts of the app's run."""
    from rgbd360_torch.apps import register_graph_sphere
    from rgbd360_torch.ops import photoicp
    from tools import synthetic_rig as rig

    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        reset_kernel_counts()
        photoicp.reset_sweep_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = register_graph_sphere.main([seq, "--calib-root", calib_root, "--max-frames", str(GRAPH_FRAMES),
                                             "--batch", str(GRAPH_BATCH), "--out", tmp, "--device", str(dev)])
        torch.cuda.synchronize()
        app_ms = (time.perf_counter() - t0) * 1000.0
        launches, sweeps = kernel_launches(), dict(photoicp.SWEEPS)
        optimized = np.loadtxt(os.path.join(tmp, "graph_poses.txt")).reshape(-1, 4, 4)
        edges = {}
        with open(os.path.join(tmp, "sphere_graph.g2o")) as f:
            for line in f:
                if line.startswith("EDGE_SE3:QUAT"):
                    fields = line.split()
                    edges[int(fields[1]), int(fields[2])] = _quat_pose([float(v) for v in fields[3:10]])
    text = buf.getvalue()
    print("".join(line + "\n" for line in text.splitlines() if not line.startswith("loaded frame")), end="", flush=True)
    n = len(optimized)
    selected = re.search(r"^(\d+) pairs selected \((\d+) chain, (\d+) LC\)$", text, re.M)
    chunk_ms = [float(ms) for ms in re.findall(r"^registered pairs \d+\.\.\d+ on device \(([0-9.]+) ms\)$", text, re.M)]
    n_pairs = int(selected.group(1))
    # every frame in one connected graph (the dense edges kept)
    component = list(range(n))
    find = lambda a: a if component[a] == a else find(component[a])
    for i, j in edges:
        component[find(i)] = find(j)
    roots = {find(a) for a in range(n)}
    # the chained trajectory: the dense chain edges (j-1, j) composed
    chained = [np.eye(4)]
    for j in range(1, n):
        if (j - 1, j) not in edges:
            raise AssertionError(f"register_graph_sphere: the chain edge {j - 1}->{j} was gated out")
        chained.append(chained[-1] @ edges[j - 1, j])
    ate_chained = rig.absolute_trajectory_error(chained, gt[:n])
    ate_optimized = rig.absolute_trajectory_error(optimized, gt[:n])
    partition = re.search(r"^partition: (.*)$", text, re.M).group(1)
    print(f"[{card}] register_graph_sphere, {n} frames of the {SLAM_FRAMES}-frame loop, batch {GRAPH_BATCH}: "
          f"{n_pairs} pairs ({selected.group(2)} chain, {selected.group(3)} loop closure), {len(edges)} edges kept, "
          f"{len(roots)} connected component(s); ATE chained {ate_chained * 1000:.3f} mm, optimized "
          f"{ate_optimized * 1000:.3f} mm; partition {partition}; align_batch ms per chunk "
          f"{np.round(chunk_ms, 3).tolist()} = {n_pairs * 1000.0 / sum(chunk_ms):.2f} pairs/s; the whole app "
          f"{app_ms:.1f} ms", flush=True)
    print(f"launches {launches} sweeps {sweeps}", flush=True)
    if rc != 0 or n != GRAPH_FRAMES or len(chunk_ms) != -(-n_pairs // GRAPH_BATCH):
        raise AssertionError(f"register_graph_sphere: rc {rc}, {n} frames, {len(chunk_ms)} chunks of {n_pairs} pairs")
    if len(roots) != 1:
        raise AssertionError(f"register_graph_sphere: {len(roots)} connected components")
    if ate_optimized > ate_chained + 0.005:
        raise AssertionError(f"register_graph_sphere: optimized ATE {ate_optimized} vs chained {ate_chained}")
    if not (launches["warp_gather_batched"] == sweeps["windowed"] > 0 and launches["warp_gather_single"] == 0
            and launches["warp_gather_batched_multi"] == sweeps["exact_final_dual"] == len(chunk_ms)):
        raise AssertionError(f"register_graph_sphere: the sweeps did not run through the kernels: {launches} vs {sweeps}")
    return launches


def _run_app(main, argv, timed=False):
    """(rc, stdout, ms) of one app run, synchronised; stage timing on when
    ``timed``."""
    from rgbd360_torch.utils import timing

    buf = io.StringIO()
    try:
        timing.stage_timing(timed)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0
    finally:
        timing.stage_timing(False)
    return rc, buf.getvalue(), ms


def _untimed(text: str) -> str:
    return "".join(line + "\n" for line in text.splitlines() if not re.match(r"^.+ took [0-9.]+ ms$", line))


def ring_errors(rt_a: np.ndarray, rt_b: np.ndarray) -> np.ndarray:
    """(8, 2): per ring pair (s, s+1 mod 8), the rotation (deg) and
    translation (m) between the pair's relative pose in rig a and in rig b."""
    out = []
    for s in range(8):
        a = np.linalg.inv(rt_a[s]) @ rt_a[(s + 1) % 8]
        b = np.linalg.inv(rt_b[s]) @ rt_b[(s + 1) % 8]
        out.append((_rot_deg(a, b), np.linalg.norm(a[:3, 3] - b[:3, 3])))
    return np.array(out)


def calibration_phase(dev, card) -> dict:
    """Phase 5i: the calibration suite on the card as a user runs it, against
    the port's CPU run. Returns the launch counts of eval_calibration's run."""
    from rgbd360_torch.apps import (calibrate_rig, eval_calibration, get_control_planes, online_calibration,
                                    pair_calibrator, visualize_calibration)
    from rgbd360_torch.apps.get_control_planes import load_correspondences
    from rgbd360_torch.core.calibrator import construction_specs
    from rgbd360_torch.ops import photoicp
    from tools import synthetic_rig as rig

    load_rt = lambda d: np.stack([np.loadtxt(os.path.join(d, f"Rt_0{s + 1}.txt")) for s in range(8)])
    frame_lines = lambda text: re.findall(r"^frame \d+: .*$", text, re.M)
    with tempfile.TemporaryDirectory() as tmp:
        calib_root, seq = os.path.join(tmp, "calib"), os.path.join(tmp, "seq")
        true = rig.perturbed_rig(0)
        t0 = time.perf_counter()
        rig.write_calib_root(calib_root)
        rig.write_sequence(seq, true, frames=CALIB_FRAMES, workers=min(8, os.cpu_count() or 1))
        print(f"calibration dataset: {CALIB_FRAMES} captures through the perturbed rig written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        common = ["--calib-root", calib_root]
        evaluate = [seq, *common, "--max-frames", str(CALIB_EVAL_FRAMES)]

        # the port's CPU run: the reference of calibrate_rig and eval_calibration
        t0 = time.perf_counter()
        rc_rig, cpu_rig, _ = _run_app(calibrate_rig.main, [seq, *common, "--out", os.path.join(tmp, "rt_cpu"),
                                                          "--device", "cpu"])
        rc_eval, cpu_eval, _ = _run_app(eval_calibration.main, evaluate + ["--device", "cpu"])
        if rc_rig or rc_eval:
            raise AssertionError(f"the CPU reference runs failed: rc {rc_rig}, {rc_eval}")
        print(f"calibration CPU reference (calibrate_rig, eval_calibration): {time.perf_counter() - t0:.1f} s",
              flush=True)

        # the card, as a user runs each app
        rc, text, rig_ms = _run_app(calibrate_rig.main, [seq, *common, "--out", os.path.join(tmp, "rt_card"),
                                                        "--device", str(dev)], timed=True)
        print(_untimed(text), end="", flush=True)
        per_frame = {name: np.round(np.sum([_stage_ms(text, s) for s in stages], axis=0), 3).tolist() for name, stages in (
            ("build (load + undistort + stitch)", ("Frame360.loadFrame", "Frame360.undistort",
                                                   "Frame360.stitchSphericalImage")),
            ("planes", ("Frame360.getPlanes (segmentation)",)), ("gather", ("Control-plane gather",)))}
        solve_ms = _stage_ms(text, "Calibration solve")
        rt_card, rt_cpu = load_rt(os.path.join(tmp, "rt_card")), load_rt(os.path.join(tmp, "rt_cpu"))
        vs_cpu, vs_truth = ring_errors(rt_card, rt_cpu), ring_errors(rt_card, true)
        spec_truth = ring_errors(construction_specs(), true)
        print(f"[{card}] calibrate_rig, {CALIB_FRAMES} frames: per-frame ms, synchronised: "
              + "; ".join(f"{k} {v}" for k, v in per_frame.items())
              + f"; solve {solve_ms} ms; the whole app {rig_ms:.1f} ms; printout (timing aside) equal to the CPU's: "
              f"{_untimed(text).replace('rt_card', 'rt_cpu') == cpu_rig}", flush=True)
        print(f"calibrate_rig ring pairs 0-1 .. 7-0: card vs CPU {np.round(vs_cpu[:, 0], 5).tolist()} deg, "
              f"{np.round(vs_cpu[:, 1] * 1000, 4).tolist()} mm; vs the truth {np.round(vs_truth[:, 0], 3).tolist()} deg "
              f"(construction specs {np.round(spec_truth[:, 0], 3).tolist()}), translation (recorded, not gated) "
              f"{np.round(vs_truth[:, 1] * 1000, 2).tolist()} mm (construction specs "
              f"{np.round(spec_truth[:, 1] * 1000, 2).tolist()})", flush=True)
        if rc != 0 or frame_lines(text) != frame_lines(cpu_rig) or len(frame_lines(text)) != CALIB_FRAMES:
            raise AssertionError(f"calibrate_rig: rc {rc}; per-frame control planes {frame_lines(text)} on the card, "
                                 f"{frame_lines(cpu_rig)} on the CPU")
        if (vs_cpu[:, 0] > CALIB_CPU_DEG).any() or (vs_cpu[:, 1] > CALIB_CPU_T).any():
            raise AssertionError(f"calibrate_rig: the card's rig differs from the CPU's: {vs_cpu}")
        if not ((vs_truth[:, 0] < spec_truth[:, 0]).all() and (vs_truth[:, 0] <= CALIB_TRUTH_DEG).all()):
            raise AssertionError(f"calibrate_rig: rotations not closer to the truth: {vs_truth[:, 0]}")

        out_cp = os.path.join(tmp, "cp")
        rc, text, ms = _run_app(get_control_planes.main, [seq, *common, "--out", out_cp, "--device", str(dev)])
        total = sum(len(rows) for rows in load_correspondences(os.path.join(out_cp, "control_planes.npz")).rows.values())
        print(f"[{card}] get_control_planes: {text.splitlines()[-2]} ({ms:.1f} ms); control_planes.npz holds {total}",
              flush=True)
        if rc != 0 or frame_lines(text) != frame_lines(cpu_rig) or f"{total} correspondences" not in text:
            raise AssertionError(f"get_control_planes: rc {rc}, {frame_lines(text)}, {total} rows in the file")
        for mode in (["--planes", os.path.join(out_cp, "control_planes.npz")], ["--dataset", seq]):
            rc, text, ms = _run_app(pair_calibrator.main, [*mode, "--pair", "1", "2", *common, "--device", str(dev)])
            print(f"[{card}] pair_calibrator {mode[0]} 1-2 ({ms:.1f} ms): " + " | ".join(text.splitlines()[:3]),
                  flush=True)
            if rc != 0:
                raise AssertionError(f"pair_calibrator {mode[0]}: rc {rc}")
        rc, text, ms = _run_app(online_calibration.main, [seq, *common, "--max-frames", str(CALIB_ONLINE_FRAMES),
                                                          "--device", str(dev)])
        print(text + f"[{card}] online_calibration, {CALIB_ONLINE_FRAMES} frames: {ms:.1f} ms", end="\n", flush=True)
        if rc != 0 or len(frame_lines(text)) != CALIB_ONLINE_FRAMES:
            raise AssertionError(f"online_calibration: rc {rc}")

        reset_kernel_counts()
        photoicp.reset_sweep_counts()
        rc, text, ms = _run_app(eval_calibration.main, evaluate + ["--device", str(dev)], timed=True)
        launches, sweeps = kernel_launches(), dict(photoicp.SWEEPS)
        align_ms = _stage_ms(text, "Dense alignment 360")
        text = _untimed(text)
        fitness = r"avScoreFitness .*: ([0-9.]+)"
        fit_card, fit_cpu = (float(re.search(fitness, t).group(1)) for t in (text, cpu_eval))
        print(text + f"[{card}] eval_calibration, {CALIB_EVAL_FRAMES} frames: {ms:.1f} ms, the dense aligns "
              f"{np.round(align_ms, 3).tolist()} ms synchronised; avScoreFitness {fit_card} on the card, {fit_cpu} on "
              f"the CPU (limit {FITNESS_LIMIT}); launches {launches} sweeps {sweeps}", flush=True)
        strip = lambda t: re.sub(fitness, "", t)
        if rc != 0 or strip(text) != strip(cpu_eval) or abs(fit_card - fit_cpu) > FITNESS_LIMIT:
            raise AssertionError(f"eval_calibration: rc {rc}, the card's printout differs from the CPU's")
        if not (launches["warp_gather_batched"] == sweeps["windowed"] > 0 and launches["warp_gather_single"] == 0
                and launches["warp_gather_batched_multi"] == sweeps["exact_final_dual"] == CALIB_EVAL_FRAMES - 1):
            raise AssertionError(f"eval_calibration: the sweeps did not run through the kernels: {launches} vs {sweeps}")

        out_vis = os.path.join(tmp, "vis")
        rc, text, ms = _run_app(visualize_calibration.main, [os.path.join(seq, "sphere_images_1.bin"), *common,
                                                             "--extrinsics", os.path.join(tmp, "rt_card"),
                                                             "--out", out_vis, "--device", str(dev)])
        print(f"[{card}] visualize_calibration frame 1 under the card's calibration ({ms:.1f} ms): "
              + " | ".join(text.splitlines()[-2:]), flush=True)
        if rc != 0 or len(re.findall(r"^seam \d->\d: ", text, re.M)) != 8 or not all(
                os.path.getsize(os.path.join(out_vis, f)) > 0 for f in ("panorama_rgb.png", "panorama_depth.png",
                                                                         "fused_cloud.ply")):
            raise AssertionError(f"visualize_calibration: rc {rc}")
    return launches


def stereo_parity(dev, png: str, depth_bin: str) -> dict:
    """The stereo frame of (png, depth_bin) on ``dev`` against the port's
    CPU run: the segment-stage labels must be equal, the refined labels
    differ at no more than LABEL_DIFF_LIMIT of the pixels with each
    explained (refine_differences), getPlanesStereo's planes equal in count
    and order, normals within PLANE_NORMAL_LIMIT, d within PLANE_D_LIMIT.
    Raises AssertionError, else returns what it measured."""
    from rgbd360_torch.core.frame360_stereo import Frame360Stereo, stereo_segments

    frames = {where: Frame360Stereo(device=where).build_stereo(png, depth_bin) for where in (dev, "cpu")}
    xyz, pre_cpu, lab_cpu = (t.cpu().numpy() for t in stereo_segments(frames["cpu"].depth_m()))
    _x, pre_dev, lab_dev = (t.cpu().numpy() for t in stereo_segments(frames[dev].depth_m()))
    pre_differ = int((pre_dev != pre_cpu).sum())
    differ = lab_dev != lab_cpu
    unexplained = refine_differences(xyz, pre_cpu, lab_dev, lab_cpu) if pre_differ == 0 else int(differ.sum())
    on_dev, on_cpu = (frames[where].get_planes_stereo().planes for where in (dev, "cpu"))
    same_count = len(on_dev) == len(on_cpu) > 0
    dn = max((float(np.abs(a.normal - b.normal).max()) for a, b in zip(on_dev, on_cpu)), default=0.0)
    dd = max((abs(a.d - b.d) for a, b in zip(on_dev, on_cpu)), default=0.0)
    out = dict(pre_differ=pre_differ, refined_differ=int(differ.sum()), share=float(differ.mean()),
               unexplained=unexplained, planes=(len(on_dev), len(on_cpu)), normal=dn, d=dd)
    if not (pre_differ == 0 and differ.mean() <= LABEL_DIFF_LIMIT and unexplained == 0 and same_count
            and dn <= PLANE_NORMAL_LIMIT and dd <= PLANE_D_LIMIT):
        raise AssertionError(f"the stereo frame on {dev} differs from the CPU's: {out}")
    return out


def stereo_phase(dev, card) -> dict:
    """Phase 5j: load_stereo on the card on the room's stereo panorama at
    1024 x 180, held to the port's CPU run; the stereo device program's warm
    time; tof_calibrator --demo on the card against the CPU and the JAX
    demo's ground-truth error. Returns the launch counts of the panorama's
    part and of the ToF calibrator's."""
    from PIL import Image

    from rgbd360_torch.apps import load_stereo, tof_calibrator
    from rgbd360_torch.core.frame360_stereo import Frame360Stereo, stereo_plane_stats, write_stereo_depth
    from tools import synthetic_rig as rig

    launches = {}
    reset_kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        rgb, depth = rig.raycast_room_stereo(rig.stereo_pose())
        png, depth_bin = os.path.join(tmp, "stereo.png"), os.path.join(tmp, "stereo_depth.bin")
        Image.fromarray(np.ascontiguousarray(rgb[..., ::-1])).save(png)
        write_stereo_depth(depth_bin, depth)
        rc, text, app_ms = _run_app(load_stereo.main, [png, depth_bin, "--planes", "--out", os.path.join(tmp, "out"),
                                                       "--device", str(dev)])
        print(text, end="", flush=True)
        parity = stereo_parity(dev, png, depth_bin)
        frame = Frame360Stereo(device=dev).build_stereo(png, depth_bin)
    h, w = frame.sphere_depth_mm.shape
    depth_m = frame.depth_m()
    program_ms = cuda_ms(lambda: stereo_plane_stats(depth_m, frame.sphere_rgb), STEREO_TIMED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame.get_planes_stereo()
    planes_ms = (time.perf_counter() - t0) * 1000.0
    print(f"[{card}] load_stereo {w}x{h} --planes: {app_ms:.1f} ms the whole app; card vs CPU: segment-stage labels "
          f"differ at {parity['pre_differ']} pixels, refined labels at {parity['refined_differ']} = "
          f"{parity['share']:.4%} (limit {LABEL_DIFF_LIMIT:.2%}), {parity['unexplained']} unexplained; planes "
          f"{parity['planes'][0]} on the card = {parity['planes'][1]} on the CPU, normal {parity['normal']:.3g} (limit "
          f"{PLANE_NORMAL_LIMIT}), d {parity['d']:.3g} m (limit {PLANE_D_LIMIT}); the stereo device program "
          f"{program_ms:.3f} ms warm (CUDA events, mean of {STEREO_TIMED}), get_planes_stereo with its host fit "
          f"{planes_ms:.1f} ms", flush=True)
    if rc != 0 or f"planes: {parity['planes'][1]}" not in text:
        raise AssertionError(f"load_stereo: rc {rc}")
    launches["stereo_panorama"] = kernel_launches()

    reset_kernel_counts()
    rc, text, tof_ms = _run_app(tof_calibrator.main, ["--demo", "--device", str(dev)])
    dr, dt = (float(x) for x in re.search(r"\|dR\|=(\S+) \|dt\|=(\S+)", text).groups())
    # the demo's estimate, computed as the app does, on the card and the CPU
    fx, o = 90.0, (79.5, 59.5)
    images = [tof_calibrator._synthetic_depth(rt, fx, fx, *o) for rt in (np.eye(4), tof_calibrator.demo_truth())]
    est = {where: tof_calibrator.match_planes(*(tof_calibrator.planes_from_depth(d, fx, fx, *o, where) for d in images),
                                              np.eye(4)).calibrate_pair() for where in (dev, "cpu")}
    gap = float(np.abs(est[dev] - est["cpu"]).max())
    print(text + f"[{card}] tof_calibrator --demo: {tof_ms:.1f} ms; estimate card vs CPU {gap:.3g} (limit 1e-5); "
          f"ground-truth error |dR| {dr} |dt| {dt} (the JAX demo's {TOF_DEMO_GT})", flush=True)
    if rc != 0 or gap > 1e-5 or dr > 1.01 * TOF_DEMO_GT[0] or dt > 1.01 * TOF_DEMO_GT[1]:
        raise AssertionError("tof_calibrator --demo: the card's estimate differs from the CPU's or misses the truth")
    launches["tof_calibrator"] = kernel_launches()
    return launches


def capture_phase(dev, card, calib_root, seq, gt, dense_traj) -> dict:
    """Phase 5k: live capture. The grabber app replays the 6-frame dataset
    into a copy (every .bin byte-equal to its source); the online odometry
    app runs on the card over the copy: every pair within the ground-truth
    bound, the first DENSE_ODOMETRY_FRAMES poses equal to the odometry app's
    dense poses of 5b within ONLINE_ODOMETRY_T, the L0-L2 sweeps carried by
    warp_gather_batched and each exact-final by one DUAL launch; then
    --synthetic 3. Returns the launch counts of the online run."""
    import filecmp

    from rgbd360_torch.apps import grabber, online_odometry
    from rgbd360_torch.ops import photoicp
    from tools import synthetic_rig as rig

    with tempfile.TemporaryDirectory() as tmp:
        copy, out = os.path.join(tmp, "copy"), os.path.join(tmp, "out")
        rc, text, grab_ms = _run_app(grabber.main, ["--replay", seq, "--out", copy])
        names = sorted(f for f in os.listdir(seq) if f.endswith(".bin"))
        same = [filecmp.cmp(os.path.join(seq, n), os.path.join(copy, n), shallow=False) for n in names]
        print(f"grabber --replay: {text.strip()}; {sum(same)} of {len(names)} .bin byte-equal to the source "
              f"({grab_ms:.1f} ms)", flush=True)
        if rc != 0 or len(names) != ODOMETRY_FRAMES or not all(same):
            raise AssertionError(f"grabber --replay: rc {rc}, {sum(same)} of {len(names)} files equal")

        reset_kernel_counts()
        photoicp.reset_sweep_counts()
        rc, text, app_ms = _run_app(online_odometry.main,
                                    ["--dataset", copy, "--calib-root", calib_root, "--out", out, "--device", str(dev)])
        launches, sweeps = kernel_launches(), dict(photoicp.SWEEPS)
        traj = np.loadtxt(os.path.join(out, "trajectory_online.txt")).reshape(-1, 4, 4)
    print("".join(line + "\n" for line in text.splitlines() if line.startswith("frame ")), end="")
    errs = rig.relative_pose_errors(traj, gt)
    vs_dense = float(np.abs(traj[:len(dense_traj)] - dense_traj).max())
    pairs = ODOMETRY_FRAMES - 1
    print(f"[{card}] online_odometry over {ODOMETRY_FRAMES} replayed frames: error vs ground truth max "
          f"{errs[:, 0].max() * 1000:.3f} mm, {errs[:, 1].max():.4f} deg (bound {rig.GT_T * 1000:.0f} mm, "
          f"{rig.GT_ROT_DEG} deg); first {len(dense_traj)} poses vs the odometry app's (5b) max |diff| {vs_dense:.3g} "
          f"(limit {ONLINE_ODOMETRY_T}); {app_ms / ODOMETRY_FRAMES:.1f} ms per frame, synchronised "
          f"({app_ms:.1f} ms the whole app)", flush=True)
    print(f"launches {launches} sweeps {sweeps}", flush=True)
    if rc != 0 or len(traj) != ODOMETRY_FRAMES:
        raise AssertionError(f"online_odometry: rc {rc}, {len(traj)} poses")
    if not ((errs[:, 0] < rig.GT_T).all() and (errs[:, 1] < rig.GT_ROT_DEG).all()):
        raise AssertionError(f"online_odometry: relative poses outside the ground-truth bound: {errs}")
    if vs_dense > ONLINE_ODOMETRY_T:
        raise AssertionError(f"online_odometry: poses {vs_dense} from the odometry app's")
    if not (launches["warp_gather_batched"] == sweeps["windowed"] > 0 and launches["warp_gather_single"] == 0
            and launches["warp_gather_batched_multi"] == sweeps["exact_final_dual"] == pairs):
        raise AssertionError(f"online_odometry: the sweeps did not run through the kernels: {launches} vs {sweeps}")

    with tempfile.TemporaryDirectory() as tmp:
        rc, text, ms = _run_app(online_odometry.main, ["--synthetic", "3", "--calib-root", calib_root, "--out", tmp,
                                                        "--device", str(dev)])
        n_poses = len(np.loadtxt(os.path.join(tmp, "trajectory_online.txt")).reshape(-1, 4, 4))
    print(f"online_odometry --synthetic 3: rc {rc}, {n_poses} poses, {text.strip().splitlines()[-1]} "
          f"({ms:.1f} ms)", flush=True)
    if rc != 0 or n_poses != 3:
        raise AssertionError(f"online_odometry --synthetic 3: rc {rc}, {n_poses} poses")
    return launches


def _panorama_diff(dir_a: str, dir_b: str, n: int) -> tuple:
    """(pixels that differ, pixels) of frame n's panorama PNGs, rgb or depth."""
    from rgbd360_torch.utils.viz import load_png

    png = lambda d, kind: load_png(os.path.join(d, f"{kind}_{n:04d}.png"))
    diff = (png(dir_a, "rgb") != png(dir_b, "rgb")).any(-1) | (png(dir_a, "depth") != png(dir_b, "depth")).any(-1)
    return int(diff.sum()), diff.size


def rawlog_phase(dev, card, calib_root) -> None:
    """Phase 5l: an MRPT rawlog of RAWLOG_FRAMES frames (4 sensors of 320 x
    240, u8 BGR raw CImage and f32 metres, plus one LASER scan per frame)
    written with the port's writer, loaded by apps/load_rawlog.py on the
    card and on the CPU in its three modes: the panoramas equal but at the
    stitch's sampling boundaries (STITCH_DIFF_LIMIT, as 5b), the undistorted
    sensor clouds within RAWLOG_CLOUD_T, the saved keyframes' planes within
    the plane parity limits of 5c."""
    from rgbd360_torch.apps import load_rawlog
    from rgbd360_torch.core.pbmap import load_pbmap
    from rgbd360_torch.io.calib import Calib360
    from tools import synthetic_rig as rig

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "room.rawlog")
        t0 = time.perf_counter()
        rig.write_rawlog_sequence(path, rig.construction_specs(), frames=RAWLOG_FRAMES)
        print(f"rawlog: {RAWLOG_FRAMES} frames of 4 RGBD observations and a LASER scan written in "
              f"{time.perf_counter() - t0:.2f} s ({os.path.getsize(path)} bytes)", flush=True)
        out = {}
        for mode in ("images", "cloud", "save"):
            for where in (str(dev), "cpu"):
                out[mode, where] = os.path.join(tmp, f"{mode}_{where}")
                rc, text, ms = _run_app(load_rawlog.main, [path, "--out", out[mode, where], "--mode", mode,
                                                           "--calib-root", calib_root, "--device", where])
                if rc != 0 or f"processed {RAWLOG_FRAMES} omnidirectional frames" not in text:
                    raise AssertionError(f"load_rawlog --mode {mode} --device {where}: rc {rc}\n{text}")
                if where != "cpu":
                    print(f"[{card}] load_rawlog --mode {mode} on the card: {ms / RAWLOG_FRAMES:.1f} ms per frame, "
                          f"synchronised ({ms:.1f} ms the whole app)", flush=True)
        worst = 0
        for n in range(RAWLOG_FRAMES):
            n_diff, n_px = _panorama_diff(out["images", str(dev)], out["images", "cpu"], n)
            worst = max(worst, n_diff)
            if n_diff > STITCH_DIFF_LIMIT * n_px:
                raise AssertionError(f"load_rawlog frame {n}: the card's panorama differs at {n_diff} pixels")
        print(f"load_rawlog images, card vs CPU: at most {worst} of {320 * 1920} panorama pixels differ "
              f"(limit {int(STITCH_DIFF_LIMIT * 320 * 1920)})", flush=True)

        # the cloud mode's clouds, computed as the app does, card against CPU
        calib = Calib360.load(calib_root)
        dev_max, nan_diff = 0.0, 0
        for frame_no, group in load_rawlog.rgbd360_frames(path):
            clouds = []
            for where in (dev, "cpu"):
                frame = load_rawlog.frame360_from_obs(calib, group, frame_no, where)
                frame.undistort()
                clouds.append(frame.build_sphere_cloud()[0])
            fin = np.isfinite(clouds[0]) & np.isfinite(clouds[1])
            nan_diff += int((np.isfinite(clouds[0]) != np.isfinite(clouds[1])).any(1).sum())
            dev_max = max(dev_max, float(np.abs(clouds[0][fin] - clouds[1][fin]).max()))
        n_pts = clouds[0].shape[0]
        print(f"load_rawlog cloud, card vs CPU: max deviation {dev_max:.3g} m (limit {RAWLOG_CLOUD_T}), "
              f"{nan_diff} of {RAWLOG_FRAMES * n_pts} points valid on one side only", flush=True)
        if dev_max > RAWLOG_CLOUD_T or nan_diff > STITCH_DIFF_LIMIT * RAWLOG_FRAMES * n_pts:
            raise AssertionError(f"load_rawlog cloud: {dev_max} m, {nan_diff} validity differences")

        for n in range(RAWLOG_FRAMES):
            card_pb = load_pbmap(os.path.join(out["save", str(dev)], f"spherePlanes_{n}.pbmap.npz"))
            cpu_pb = load_pbmap(os.path.join(out["save", "cpu"], f"spherePlanes_{n}.pbmap.npz"))
            if not len(card_pb.planes) == len(cpu_pb.planes) > 0:
                raise AssertionError(f"load_rawlog save frame {n}: {len(card_pb.planes)} planes on the card, "
                                     f"{len(cpu_pb.planes)} on the CPU")
            pairs = list(zip(card_pb.planes, cpu_pb.planes))
            dn = max(float(np.abs(a.normal - b.normal).max()) for a, b in pairs)
            dd = max(abs(a.d - b.d) for a, b in pairs)
            da = max(abs(a.area_hull - b.area_hull) / b.area_hull for a, b in pairs)
            print(f"load_rawlog save frame {n}: {len(card_pb.planes)} planes on the card and the CPU; normal {dn:.3g}, "
                  f"d {dd:.3g} m, hull area {da:.3g} relative", flush=True)
            if dn > PLANE_NORMAL_LIMIT or dd > PLANE_D_LIMIT or da > PLANE_AREA_LIMIT:
                raise AssertionError(f"load_rawlog save frame {n}: planes outside the parity limits")


def mesh_phase(dev, card, operands, main_res) -> dict:
    """Phase 5m: the pair mesh. align_batch_sharded over make_mesh() on the
    golden pair at batch 8 bit-equal to phase 4's align_batch; the dry run
    over [dev, dev] (two shards of 4 pairs, a thread each), every leg bit-
    equal to its unsplit call and its launches equal to its sweeps; the ms
    per batch of the split against the unsplit call. Returns the launch
    counts of the golden split, the dry run's kernel leg and its loop-
    closure leg."""
    from rgbd360_torch.ops import photoicp
    from rgbd360_torch.parallel import dryrun
    from rgbd360_torch.parallel import mesh as pmesh
    from rgbd360_torch.parallel.batch import align_batch

    mesh = pmesh.make_mesh()
    mesh = mesh[:max(d for d in (1, 2, 4, 8) if d <= len(mesh))]  # the cards that divide the batch
    reset_kernel_counts()
    photoicp.reset_sweep_counts()
    res = pmesh.align_batch_sharded(mesh, *operands, photoicp.PHOTO_DEPTH, N_LEVELS)
    torch.cuda.synchronize()
    golden = (kernel_launches(), dict(photoicp.SWEEPS))
    dryrun.assert_same_result(res, main_res, "mesh golden")
    print(f"[{card}] align_batch_sharded over make_mesh() ({len(mesh)} shard(s), {len(set(mesh))} distinct card(s)) "
          f"on the golden pair, B={BATCH}: bit-equal to phase 4's align_batch, signature "
          f"{tuple(res.num_iterations[0].tolist())}; launches {golden[0]} sweeps {golden[1]}", flush=True)
    if not (golden[0]["warp_gather_batched"] == golden[1]["windowed"] > 0
            and golden[0]["warp_gather_batched_multi"] == golden[1]["exact_final_dual"] == len(mesh)):
        raise AssertionError(f"mesh golden: the sweeps did not run through the kernels: {golden}")

    report = dryrun.dryrun_multichip(2, dev)
    lc, kernel = report["lc"], report["kernel"]
    print(f"[{card}] dryrun_multichip over [{dev}, {dev}] (1 distinct card): tracking leg iterations "
          f"{report['tracking']['iterations']}; loop-closure leg launches {lc['launches']} sweeps {lc['sweeps']}; "
          f"kernel leg launches {kernel['launches']} sweeps {kernel['sweeps']}", flush=True)
    if not (lc["launches"]["warp_gather_batched_multi"] == lc["sweeps"]["full_coverage"] > 0
            and lc["launches"]["warp_gather_batched"] == lc["sweeps"]["windowed"] == 0):
        raise AssertionError(f"mesh LC leg: the full-coverage sweeps did not launch the FULL form: {lc}")
    if not (kernel["launches"]["warp_gather_batched"] == kernel["sweeps"]["windowed"] > 0
            and kernel["launches"]["warp_gather_batched_multi"] == kernel["sweeps"]["exact_final_dual"] == 2):
        raise AssertionError(f"mesh kernel leg: the sweeps did not run through the kernels: {kernel}")

    # split against unsplit on the golden batch, in turns
    split_mesh = [dev, dev]
    runs = {"split [dev, dev]": lambda: pmesh.align_batch_sharded(split_mesh, *operands, photoicp.PHOTO_DEPTH, N_LEVELS),
            "unsplit": lambda: align_batch(*operands, photoicp.PHOTO_DEPTH, N_LEVELS)}
    samples = {name: [] for name in runs}
    for k in range(MESH_ROUNDS):
        for name in (list(runs) if k % 2 == 0 else list(runs)[::-1]):
            samples[name].append(cuda_ms(runs[name], TIMED_ALIGNS))
    print(f"[{card}] golden align B={BATCH}, median of {MESH_ROUNDS} alternating rounds of {TIMED_ALIGNS}: "
          + "; ".join(f"{name} {np.median(ms):.3f} ms/batch" for name, ms in samples.items())
          + f" (a record, no claim); samples {json.dumps(samples)}", flush=True)
    return {"mesh_golden": golden[0], "mesh_split": kernel["launches"], "mesh_lc": lc["launches"]}


def live_view_phase(dev, card, calib_root, seq) -> None:
    """The live map viewer: kf_sphere_slam over the first LIVE_FRAMES frames
    of the loop with --live-view DIR --live-port 0. live.json is fetched
    from the viewer's URL on 127.0.0.1 while the app runs (a poller thread
    reads the URL the app prints), and read after the run: its trajectory
    has one entry per keyframe of the map."""
    import threading
    import urllib.request

    from rgbd360_torch.apps import kf_sphere_slam

    with tempfile.TemporaryDirectory() as tmp:
        short, live = os.path.join(tmp, "seq"), os.path.join(tmp, "live")
        os.mkdir(short)
        for n in range(1, LIVE_FRAMES + 1):
            os.symlink(os.path.join(seq, f"sphere_images_{n}.bin"), os.path.join(short, f"sphere_images_{n}.bin"))
        buf, fetched, done = io.StringIO(), [], threading.Event()

        def poll():
            while not done.is_set():
                found = re.search(r"^live viewer: (http://127\.0\.0\.1:\d+)/live\.html$", buf.getvalue(), re.M)
                if found:
                    try:
                        with urllib.request.urlopen(found.group(1) + "/live.json", timeout=5) as r:
                            fetched.append(len(json.loads(r.read())["traj"]))
                    except OSError:
                        pass  # the server closes as the app ends
                done.wait(0.05)

        poller = threading.Thread(target=poll, name="live_json_poller")
        poller.start()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                slam = kf_sphere_slam.run([short, "--calib-root", calib_root, "--device", str(dev),
                                           "--live-view", live, "--live-port", "0"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1000.0
        finally:
            done.set()
            poller.join()
        with open(os.path.join(live, "live.json")) as f:
            final = json.load(f)
    n_kf = len(slam.world)
    print(f"[{card}] kf_sphere_slam --live-view over {LIVE_FRAMES} frames: {n_kf} keyframes; live.json fetched "
          f"{len(fetched)} times over 127.0.0.1 while the app ran (trajectory lengths {sorted(set(fetched))}), "
          f"final trajectory {len(final['traj'])} entries; {ms:.1f} ms the whole app", flush=True)
    if not fetched or fetched != sorted(fetched) or max(fetched) > n_kf or len(final["traj"]) != n_kf:
        raise AssertionError(f"live view: fetched {fetched}, final {len(final['traj'])}, keyframes {n_kf}")


def gather_bound_ms(*tensors) -> float:
    """Least time to move ``tensors`` once each through HBM, in ms."""
    return sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S * 1000.0


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
    max_err = {"warp_gather_batched": 0.0, "warp_gather_batched_multi": 0.0, "warp_gather_single": 0.0}
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
            ("warp_gather_single", "mean", None),
        ]
        for name, how, active in cases:
            if name == "warp_gather_batched":
                got = warp_gather.warp_gather_batched(planes, r2d, c2d, active, row_policy=how)
                want = warp_gather.warp_gather_batched_plain(planes, r2d, c2d, active, row_policy=how)
            elif name == "warp_gather_single":
                got = warp_gather.warp_gather_single(planes, r2d, c2d)
                want = warp_gather.warp_gather_single_plain(planes, r2d, c2d)
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
            l0_operands = (planes, r2d, c2d, miss, vis2d.contiguous())

    # -- 4. the main path ---------------------------------------------------------
    reset_kernel_counts()
    photoicp.reset_sweep_counts()
    res = align_batch(gray_src, depth_src, gray_trg, depth_trg, eye, photoicp.PHOTO_DEPTH, N_LEVELS)
    torch.cuda.synchronize()
    launches = kernel_launches()
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
    main_res = res  # held against the pair mesh's split in 5m
    if not (launches["warp_gather_batched"] == sweeps["windowed"] > 0
            and launches["warp_gather_batched_multi"] == sweeps["exact_final_dual"] == 1):
        raise AssertionError(f"the main path did not run through the kernels: {launches} vs {sweeps}")

    # the single-buffer route: warp_gather_batched runs the _kernel pass
    try:
        warp_gather.PIPELINE_KERNEL = False
        reset_kernel_counts()
        photoicp.reset_sweep_counts()
        res = align_batch(gray_src, depth_src, gray_trg, depth_trg, eye, photoicp.PHOTO_DEPTH, N_LEVELS)
        torch.cuda.synchronize()
        single_launches, single_sweeps = kernel_launches(), dict(photoicp.SWEEPS)
    finally:
        warp_gather.PIPELINE_KERNEL = True
    poses = res.pose.cpu().numpy()
    for i in range(BATCH):
        ok, reasons = bench.sanity_check(
            poses[i], float(res.error[i]), bool(res.ill_posed[i]), res.num_iterations[i].cpu().numpy(),
            golden=golden, kernel_path=True,
        )
        if not ok:
            raise AssertionError(f"pair {i} fails the kernel-path rails on the single-buffer route: {reasons}")
    print(f"align_batch B={BATCH} single-buffer route: signature {tuple(res.num_iterations[0].tolist())} "
          f"|t| {np.linalg.norm(poses[0][:3, 3]):.6f} m error {float(res.error[0]):.6f} "
          f"pose spread {float(np.abs(poses - poses[0]).max()):.3g}", flush=True)
    print(f"launches {single_launches} sweeps {single_sweeps}", flush=True)
    if not (single_launches["warp_gather_single"] == single_sweeps["windowed"] > 0
            and single_launches["warp_gather_batched"] == 0
            and single_launches["warp_gather_batched_multi"] == single_sweeps["exact_final_dual"] == 1):
        raise AssertionError(f"the single-buffer route did not run through its kernel: {single_launches} vs {single_sweeps}")

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

    # -- 5b-5d. odometry over raw captures, the plane layer ----------------------
    from tools import synthetic_rig as rig

    with tempfile.TemporaryDirectory() as tmp:
        calib_root, seq = os.path.join(tmp, "calib"), os.path.join(tmp, "seq")
        t0 = time.perf_counter()
        gt = rig.write_sequence(seq, rig.write_calib_root(calib_root), frames=ODOMETRY_FRAMES)
        print(f"odometry dataset: {ODOMETRY_FRAMES} frames written in {time.perf_counter() - t0:.2f} s", flush=True)
        odometry_launches, dense_traj = odometry_phase(dev, card, calib_root, seq, gt)
        plane_layer_launches = planes_phase(dev, card, calib_root, seq)
        planes_launches = with_planes_phase(dev, card, calib_root, seq, gt)
        methods_launches, occ1_launches = methods_phase(dev, card, calib_root, seq, gt)
        t0 = time.perf_counter()
        online_launches = capture_phase(dev, card, calib_root, seq, gt, dense_traj)
        rawlog_phase(dev, card, calib_root)
        print(f"phases 5k-5l: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 5e-5f. the SLAM loop -----------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        calib_root, seq = os.path.join(tmp, "calib"), os.path.join(tmp, "seq")
        t0 = time.perf_counter()
        gt = rig.write_sequence(seq, rig.write_calib_root(calib_root), frames=SLAM_FRAMES, loops=SLAM_LOOPS,
                                radius=SLAM_RADIUS, workers=min(8, os.cpu_count() or 1))
        print(f"SLAM loop: {SLAM_FRAMES} frames written in {time.perf_counter() - t0:.2f} s", flush=True)
        refine_measured = refine_phase(dev, card, calib_root, seq)
        slam_launches = slam_phase(dev, card, calib_root, seq, gt)
        kf_slam_launches = kf_slam_phase(dev, card, calib_root, seq)
        graph_launches = graph_phase(dev, card, calib_root, seq, gt)
        live_view_phase(dev, card, calib_root, seq)

    # -- 5i-5j. the calibration suite, the stereo frame and the ToF calibrator ------------
    t0 = time.perf_counter()
    calibration_launches = calibration_phase(dev, card)
    stereo_launches = stereo_phase(dev, card)
    print(f"phases 5i-5j: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 5m. the pair mesh ----------------------------------------------------------------
    t0 = time.perf_counter()
    mesh_launches = mesh_phase(dev, card, (gray_src, depth_src, gray_trg, depth_trg, eye), main_res)
    print(f"phase 5m: {time.perf_counter() - t0:.1f} s", flush=True)
    # each path's launch counts, reset just before the path ran
    path_launches = {
        "golden_align": launches, "golden_align_single_buffer": single_launches,
        "dense_odometry": odometry_launches["default"],
        "dense_odometry_single_buffer": odometry_launches["single-buffer"],
        "with_planes_odometry": planes_launches,
        "slam_loop": slam_launches, "kf_slam_loop": kf_slam_launches,
        "methods_register": methods_launches, "methods_register_occ1": occ1_launches,
        "register_graph_sphere": graph_launches, "eval_calibration": calibration_launches,
        "online_odometry": online_launches, **mesh_launches,
        "plane_layer": plane_layer_launches, **stereo_launches,
    }

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

    planes, r2d, c2d, miss, vis2d = l0_operands
    # (kernel, plain version, operands) per kernel; the multi-anchor pass
    # with both of its anchor sets: DUAL re-gathers the exact-final miss set,
    # FULL every visible pixel of a full-coverage sweep
    timed = {
        "warp_gather_batched": (
            lambda: warp_gather.warp_gather_batched(planes, r2d, c2d),
            lambda: warp_gather.warp_gather_batched_plain(planes, r2d, c2d),
            (planes, r2d, c2d),
        ),
        "warp_gather_batched_multi": (
            lambda: warp_gather.warp_gather_batched_multi(planes, r2d, c2d, miss, anchors=warp_gather.DUAL),
            lambda: warp_gather.warp_gather_batched_multi_plain(planes, r2d, c2d, miss, anchors=warp_gather.DUAL),
            (planes, r2d, c2d, miss),
        ),
        "warp_gather_batched_multi FULL": (
            lambda: warp_gather.warp_gather_batched_multi(planes, r2d, c2d, vis2d, anchors=warp_gather.FULL),
            lambda: warp_gather.warp_gather_batched_multi_plain(planes, r2d, c2d, vis2d, anchors=warp_gather.FULL),
            (planes, r2d, c2d, vis2d),
        ),
        "warp_gather_single": (
            lambda: warp_gather.warp_gather_single(planes, r2d, c2d),
            lambda: warp_gather.warp_gather_single_plain(planes, r2d, c2d),
            (planes, r2d, c2d),
        ),
    }
    replaces = {
        "warp_gather_batched": "rgbd360_tpu/ops/warp_gather.py:254",
        "warp_gather_batched_multi": "rgbd360_tpu/ops/warp_gather.py:363",
        "warp_gather_single": "rgbd360_tpu/ops/warp_gather.py:86",
    }
    # each kernel's ``launches`` come from one run of the path it carries:
    # the golden align for the pipelined passes, the single-buffer dense
    # odometry for the _kernel pass; ``launches_by_path`` lists every run's
    # (the FULL form's launches are the SLAM loop's)
    reported_path = {
        "warp_gather_batched": "golden_align", "warp_gather_batched_multi": "golden_align",
        "warp_gather_single": "dense_odometry_single_buffer",
    }
    measured = {}
    for label, (kernel_fn, plain_fn, operands) in timed.items():
        # in turns: kernel, plain, plain, kernel
        k1, p1, p2, k2 = (cuda_ms(fn, TIMED_GATHERS) for fn in (kernel_fn, plain_fn, plain_fn, kernel_fn))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        out, mask = kernel_fn()
        bound_ms = gather_bound_ms(*operands, out, mask)
        measured[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}
        print(f"[{card}] {label} at L0 ({BATCH}, 320, 8, 1920): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by bytes ({bound_ms / ms:.1%} of it reached)", flush=True)
    kernels = []
    for name in replaces:
        record = {
            "name": name, "route": "cuda", "source": "rgbd360_torch/csrc/warp_gather.cu",
            "replaces": replaces[name], "launches": path_launches[reported_path[name]][name],
            "launches_by_path": {path: counts[name] for path, counts in path_launches.items()},
            "max_abs_err": max_err[name],
            **measured[name], "bound_by": "bytes",
            # no single PyTorch call computes the windowed gather with its
            # coverage mask (planes[b, :, r, c] is the exact gather)
            "library_ms": None,
        }
        if name == "warp_gather_batched_multi":
            # ms / plain_ms / bound_ms above are the DUAL set's (as before the
            # SLAM loop); both sets here
            record["anchor_sets"] = {"dual": measured[name], "full": measured[name + " FULL"]}
        kernels.append(record)

    # the refinement's launches in every path that counted them (the dry
    # run's legs count their gathers alone); each path that builds planes
    # on the card launched it
    refine_by_path = {path: counts["refine_grow"] for path, counts in path_launches.items() if "refine_grow" in counts}
    missed = [path for path in ("plane_layer", "with_planes_odometry", "slam_loop", "kf_slam_loop", "stereo_panorama",
                                "tof_calibrator") if refine_by_path[path] == 0]
    if missed:
        raise AssertionError(f"the refinement did not launch its kernel in {missed}: {refine_by_path}")
    kernels.append({
        "name": "refine_grow", "route": "cuda", "source": "rgbd360_torch/csrc/planes_refine.cu",
        "replaces": "rgbd360_tpu/ops/planes_seg.py:313 (a lax.while_loop; no Pallas kernel)",
        "launches": refine_by_path["slam_loop"], "launches_by_path": refine_by_path, **refine_measured,
        "bound_by": "bytes", "library_ms": None,
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
