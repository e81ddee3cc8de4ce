"""The benchmark's frozen pieces held to the program and the tools they
were copied from, on the CPU at small sizes: the traffic generator byte for
byte, the plain reference's gather, panoramas, aligner and pose graph."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench360.lib import rig  # noqa: E402
from bench360.reference import api, frames, gather, graph  # noqa: E402
from bench360.reference import photoicp as ref_photoicp  # noqa: E402


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """Three captures 6 deg apart and their calibration root, from the frozen generator."""
    tmp = str(tmp_path_factory.mktemp("room"))
    rts = rig.write_calib_root(os.path.join(tmp, "calib"), 5)
    poses = rig.circle_poses(3, 6.0, 0.8)
    paths = rig.write_captures(os.path.join(tmp, "seq"), poses, [0, 1, 2], rts, 1)
    return tmp, paths


def test_generator_writes_the_bytes_of_tools_synthetic_rig(room, tmp_path):
    from tools import synthetic_rig

    tmp, paths = room
    rts = synthetic_rig.write_calib_root(str(tmp_path / "calib"), 5)
    synthetic_rig.write_sequence(str(tmp_path / "seq"), rts, frames=3, loops=0.05)
    for sub in ("Calibration/Extrinsics/Rt_03.txt", "Calibration/Intrinsics/distortion_model4",
                "config_files/configLocaliser_sphericalOdometry.ini"):
        assert open(os.path.join(tmp, "calib", sub), "rb").read() == open(tmp_path / "calib" / sub, "rb").read()
    for p in paths:
        assert open(p, "rb").read() == open(tmp_path / "seq" / os.path.basename(p), "rb").read()


def test_panoramas_equal_the_programs(room):
    from rgbd360_torch.core.frame360 import Frame360
    from rgbd360_torch.io.calib import Calib360

    tmp, paths = room
    stitcher = frames.Stitcher(os.path.join(tmp, "calib"), "cpu")
    calib = Calib360.load(os.path.join(tmp, "calib"))
    for k, p in enumerate(paths):
        f = Frame360(calib, k + 1, "cpu")
        f.load_frame(p)
        f.stitch_spherical_image()
        rgb, depth = stitcher.panorama(p)
        assert torch.equal(rgb, f.sphere_rgb) and torch.equal(depth, f.sphere_depth_mm)


@pytest.mark.parametrize("anchors", [("mean",), ("min",), ("max",), gather.DUAL, gather.FULL])
def test_gather_equals_the_programs_plain_gather(anchors):
    from rgbd360_torch.ops import warp_gather

    g = torch.Generator().manual_seed(len(anchors))
    planes = torch.randn(2, 40, 8, 256, generator=g)
    r = torch.randint(0, 40, (2, 40, 256), generator=g, dtype=torch.int32)
    c = torch.randint(0, 256, (2, 40, 256), generator=g, dtype=torch.int32)
    active = torch.rand(2, 40, 256, generator=g) > 0.3
    if len(anchors) == 1:
        ours = gather.warp_gather_batched(planes, r, c, active, anchors[0])
        theirs = warp_gather.warp_gather_batched_plain(planes, r, c, active, anchors[0])
    else:
        ours = gather.warp_gather_batched_multi(planes, r, c, active, anchors=anchors)
        theirs = warp_gather.warp_gather_batched_multi_plain(planes, r, c, active, anchors=anchors)
    assert torch.equal(ours[0].view(torch.int32), theirs[0].view(torch.int32)) and torch.equal(ours[1], theirs[1])


@pytest.mark.parametrize("full_coverage", [False, True])
def test_aligner_equals_the_program_on_the_windowed_route(room, monkeypatch, full_coverage):
    """Both aligners forced onto the windowed route (the card's) on the CPU,
    where each runs its plain gather: the same bits."""
    from rgbd360_torch.ops import photoicp
    from rgbd360_torch.parallel.batch import align_batch

    windowed = lambda shape, device: shape[0] * shape[1] >= photoicp.WARP_KERNEL_MIN_PIXELS
    monkeypatch.setattr(photoicp, "_use_warp_kernel", windowed)
    monkeypatch.setattr(ref_photoicp, "_use_warp_kernel", windowed)
    tmp, paths = room
    stitcher = frames.Stitcher(os.path.join(tmp, "calib"), "cpu")
    ins = [stitcher.aligner_input(p) for p in paths]
    stack = lambda ks, part: torch.stack([ins[k][part] for k in ks])
    guess = np.stack([np.eye(4, dtype=np.float32)] * 2)
    prog = align_batch(stack([1, 2], 0), stack([1, 2], 1), stack([0, 1], 0), stack([0, 1], 1),
                       torch.from_numpy(guess), full_coverage=full_coverage)
    ref = api.align(stack([1, 2], 0), stack([1, 2], 1), stack([0, 1], 0), stack([0, 1], 1), guess, full_coverage)
    assert np.array_equal(prog.pose.numpy(), ref["pose"])
    assert np.array_equal(prog.num_iterations.numpy(), ref["iters"])
    assert np.array_equal(prog.av_depth_residual.numpy(), ref["av_depth"])
    assert np.abs(ref["pose"][:, :3, 3]).max() > 0.05  # the pairs moved


def test_pose_graph_equals_the_programs():
    from rgbd360_torch.core.graph_optimizer import GraphOptimizer

    rng = np.random.default_rng(0)
    truth = [np.eye(4)]
    for _ in range(7):
        step = np.eye(4)
        step[:3, 3] = rng.normal(0.0, 0.2, 3)
        truth.append(truth[-1] @ step)
    noisy = [t.copy() for t in truth]
    for t in noisy[1:]:
        t[:3, 3] += rng.normal(0.0, 0.02, 3)
    edges = [(i, i + 1, np.linalg.inv(truth[i]) @ truth[i + 1], np.eye(6) * 50) for i in range(7)]
    edges.append((0, 7, np.linalg.inv(truth[0]) @ truth[7], np.eye(6) * 20))
    prog = GraphOptimizer(robust=True)
    for v in noisy:
        prog.add_vertex(v)
    for e in edges:
        prog.add_edge(*e)
    prog.optimize_graph()
    ours = api.optimize(noisy, edges, 10, 1e-6, robust=True)
    assert all(np.array_equal(a, b) for a, b in zip(ours, prog.get_poses()))
    with api.precision(lower=True):
        low = api.optimize(noisy, edges, 10, 1e-6, robust=True)
    assert graph.FLOAT is np.float64
    assert max(np.abs(a - b).max() for a, b in zip(low, ours)) > 0.0
