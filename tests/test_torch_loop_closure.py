"""Loop closure and relocalization of the port (rgbd360_torch/core/
{loop_closure,relocalizer,batch_match}.py) against the JAX package, on the
CPU, on room frames.

The room: the textured box of tests/room_scene.py (no pillars), ray-cast
through the construction-spec rig by the port's ray-caster
(tools/synthetic_rig.py::raycast_room_sensor) once per pose; both packages
build their frames (stitch + get_planes(need_inliers=False)) from the same
rays. The map state (poses, increments, areas) is built in JAX and carried
into the port with rgbd360_torch/convert.py, so both search the same map.

The scenarios are tests/test_loop_closure.py's: a new keyframe near two
older ones far away in trajectory (two survivors: the batched refinement),
and one near one (one survivor: the facade's refinement), at the
reference's gates. Both packages refine on the exact route on the CPU
(JAX routes the windowed kernel only on a TPU).

Tolerances: the same accepted set; each edge's translation within 5 mm of
JAX's (the two packages' aligners agree to the last few ulps, and the
accept/reject stopping rule can amplify those; tests/test_loop_closure.py
holds JAX's batched and sequential refinements to the same 5 mm) and within
8 cm of the truth. The refinement on the port's windowed route (the FULL
gather's plain version, L0-L2) lands within 6 cm / 2 deg of the exact
route, as test_torch_photoicp.py holds the golden pair. Dropping the
power-of-two bucket padding changes no pose by more than 1e-5. The
relocalizer on PbMaps carried across: the same keyframe, the pose within
1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from rgbd360_torch import convert  # noqa: E402
from rgbd360_torch.core import batch_match as t_bm  # noqa: E402
from rgbd360_torch.core import loop_closure as t_lc  # noqa: E402
from rgbd360_torch.core import relocalizer as t_reloc  # noqa: E402
from rgbd360_torch.core.frame360 import Frame360 as TFrame  # noqa: E402
from rgbd360_torch.core.register_photoicp import RegisterPhotoICP as TRegister  # noqa: E402
from rgbd360_torch.io.calib import Calib360 as TCalib  # noqa: E402
from rgbd360_torch.ops import photoicp as tp  # noqa: E402
from rgbd360_torch.ops import se3 as t_se3  # noqa: E402
from rgbd360_torch.ops import warp_gather as tw  # noqa: E402
from rgbd360_tpu.core import batch_match as j_bm  # noqa: E402
from rgbd360_tpu.core import loop_closure as j_lc  # noqa: E402
from rgbd360_tpu.core import relocalizer as j_reloc  # noqa: E402
from rgbd360_tpu.core.frame360 import Frame360 as JFrame  # noqa: E402
from rgbd360_tpu.core.graph_optimizer import GraphOptimizer as JOptimizer  # noqa: E402
from rgbd360_tpu.core.map360 import Map360 as JMap  # noqa: E402
from rgbd360_tpu.core.matcher import PLANAR_3DOF  # noqa: E402
from rgbd360_tpu.io.calib import Calib360 as JCalib  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402


def _pose(x=0.0, y=0.0, z=0.0):
    p = np.eye(4)
    p[:3, 3] = (x, y, z)
    return p


# tests/test_loop_closure.py:162-167
REL1 = _pose(y=0.25, z=-0.1)
REL2 = _pose(x=0.1, y=-0.2)


def room_frames(calib_root, poses):
    """[(port frame on the CPU, JAX frame)] of the empty room seen from each
    rig pose, both from the same ray-cast captures."""
    tc, jc = TCalib.load(calib_root), JCalib.load(calib_root)
    out = []
    for i, pose in enumerate(poses):
        raw = rig.room_capture(pose, tc.Rt, obstacles=())
        ft = TFrame(tc, i, "cpu")
        ft.rgb, ft.depth_raw_mm = torch.from_numpy(raw.rgb), torch.from_numpy(raw.depth)
        ft.depth_undistorted_m = ft.depth_raw_mm.to(torch.float32) * 0.001
        fj = JFrame(jc, i)
        fj.rgb, fj.depth_raw_mm = jnp.asarray(raw.rgb), jnp.asarray(raw.depth)
        fj.depth_undistorted_m = fj.depth_raw_mm.astype(jnp.float32) * 0.001
        for f in (ft, fj):
            f.stitch_spherical_image()
            f.get_planes(need_inliers=False)
        out.append((ft, fj))
    return out


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Room frames at the origin, REL2 and REL1 (kf 0, 1, 2 of the
    two-candidate case)."""
    root = str(tmp_path_factory.mktemp("lc_room"))
    rig.write_calib_root(root)
    return room_frames(root, [np.eye(4), REL2, REL1])


def _worlds(frames, kfs, increments):
    """(JAX map + optimizer, port map + optimizer carried across) holding
    the frames ``kfs`` at their true poses, with the given trajectory
    increments (a rig that wandered far and came back)."""
    poses = {0: np.eye(4), 1: REL2, 2: REL1}
    j_world, j_opt = JMap(), JOptimizer()
    for k in kfs:
        j_world.add_keyframe(frames[k][1], poses[k].astype(np.float32))
        j_opt.add_vertex(poses[k])
    j_world.trajectory_increments = list(increments)
    t_world = convert.map_from_numpy(j_world, [frames[k][0] for k in kfs])
    return (j_world, j_opt), (t_world, convert.optimizer_from_numpy(j_opt))


def _edge_t(world, kf, cand):
    return np.asarray(world.connection_kfs[kf][cand][0], np.float64)


def test_two_candidates_take_the_batched_refinement_and_match_jax(frames, monkeypatch):
    (j_world, j_opt), (t_world, t_opt) = _worlds(frames, (0, 1, 2), [0.0, 8.0, 16.0])
    lc_j = j_lc.LoopClosure360(j_world, j_opt)
    lc_t = t_lc.LoopClosure360(t_world, t_opt, device="cpu")
    with t_world.mutex:
        assert len(lc_t._candidates(2)) == 2  # the batched path will engage
    batches = []
    refine = t_lc.LoopClosure360._refine_batch
    monkeypatch.setattr(t_lc.LoopClosure360, "_refine_batch",
                        lambda self, kf, surv: batches.append(list(surv)) or refine(self, kf, surv))
    assert lc_t.process_new_keyframe(2) == lc_j.process_new_keyframe(2) == 2
    assert lc_t.refinements == [2]
    assert sorted(lc_t.accepted) == [(0, 2, True), (1, 2, True)]
    assert set(t_world.connection_kfs[2]) == set(j_world.connection_kfs[2]) == {0, 1}
    assert set(lc_t.connections_lc[2]) == {0, 1}
    assert len(t_opt.edges) == len(j_opt.edges) == 2
    for cand, truth in ((0, REL1), (1, np.linalg.inv(REL2) @ REL1)):
        got, want = _edge_t(t_world, 2, cand), _edge_t(j_world, 2, cand)
        np.testing.assert_allclose(got[:3, 3], want[:3, 3], atol=5e-3)
        np.testing.assert_allclose(got[:3, 3], truth[:3, 3], atol=0.08)

    # no bucket padding: the same survivors padded to B=3 (the last one
    # repeated, as JAX pads) give the same poses
    (survivors,) = batches
    plain = lc_t._refine_batch(frames[2][0], survivors)
    padded = lc_t._refine_batch(frames[2][0], survivors + survivors[-1:])
    assert [r[0] for r in padded[:2]] == [r[0] for r in plain] == [1, 0]  # newest first
    for a, b in zip(plain, padded):
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-5)
        assert abs(a[2] - b[2]) < 1e-5

    # each accepted edge equals the facade's sequential full-coverage
    # refinement of the same pair to 5 mm (tests/test_loop_closure.py:221)
    aligner = TRegister(5, device="cpu")
    for cand in (0, 1):
        rel = _edge_t(t_world, 2, cand)
        aligner.set_target_frame(frames[cand][0].sphere_rgb, frames[cand][0].sphere_depth_mm)
        aligner.set_source_frame(frames[2][0].sphere_rgb, frames[2][0].sphere_depth_mm)
        seed = lc_t.rot_offset @ rel @ np.linalg.inv(lc_t.rot_offset)
        aligner.align_frames360(seed.astype(np.float32), tp.PHOTO_DEPTH, full_coverage=True)
        seq = np.linalg.inv(lc_t.rot_offset) @ aligner.get_optimal_pose().astype(np.float64) @ lc_t.rot_offset
        np.testing.assert_allclose(rel[:3, 3], seq[:3, 3], atol=5e-3)


def test_one_candidate_takes_the_facade_at_the_reference_gates(frames):
    """tests/test_loop_closure.py:121: the plane-rich room passes the
    reference's gates (> 5 matched planes, area > 15, avDepthResidual < 2)
    unsoftened; one survivor refines through the facade."""
    assert (t_lc.MIN_MATCHES, t_lc.MIN_AREA_MATCHED, t_lc.MAX_DEPTH_RESIDUAL) == (5, 15.0, 2.0)
    (j_world, j_opt), (t_world, t_opt) = _worlds(frames, (0, 2), [0.0, 8.0])
    lc_j = j_lc.LoopClosure360(j_world, j_opt)
    lc_t = t_lc.LoopClosure360(t_world, t_opt, device="cpu")
    assert lc_t.process_new_keyframe(1) == lc_j.process_new_keyframe(1) == 1
    assert lc_t.refinements == [1] and lc_t.accepted == [(0, 1, False)]
    got, want = _edge_t(t_world, 1, 0), _edge_t(j_world, 1, 0)
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], atol=5e-3)
    np.testing.assert_allclose(got[:3, 3], REL1[:3, 3], atol=0.08)
    np.testing.assert_allclose(t_opt.edges[0].info, j_opt.edges[0].info, rtol=0,
                               atol=1e-2 * np.abs(j_opt.edges[0].info).max())


def test_trajectory_gap_and_distance_gate_the_candidates(frames):
    (_j, _jo), (t_world, _to) = _worlds(frames, (0, 1, 2), [0.0, 0.2, 0.4])
    lc_t = t_lc.LoopClosure360(t_world, None, device="cpu")
    assert lc_t.process_new_keyframe(2) == 0  # nearby in trajectory: no candidate
    t_world.trajectory_increments[2] = 16.0
    t_world.trajectory_poses[0] = _pose(x=9.0).astype(np.float32)  # 9 m away
    with t_world.mutex:
        assert lc_t._candidates(2) == [1]


def test_windowed_route_refinement_lands_on_the_exact_route(frames, monkeypatch):
    """One full-coverage refinement of the single-survivor pair on the
    port's windowed route (L0-L2 through the triple-anchored gather's plain
    version, as the card runs the FULL kernel) against the exact route."""
    seed_pb = _seed(frames, 0, 2)
    aligner = TRegister(5, device="cpu")
    aligner.set_target_frame(frames[0][0].sphere_rgb, frames[0][0].sphere_depth_mm)
    aligner.set_source_frame(frames[2][0].sphere_rgb, frames[2][0].sphere_depth_mm)
    exact = aligner.align_frames360(seed_pb, tp.PHOTO_DEPTH, full_coverage=True)
    monkeypatch.setattr(tp, "_use_warp_kernel", lambda shape, device: shape[0] * shape[1] >= tp.WARP_KERNEL_MIN_PIXELS)
    tp.reset_sweep_counts()
    windowed = aligner.align_frames360(seed_pb, tp.PHOTO_DEPTH, full_coverage=True)
    assert tp.SWEEPS["full_coverage"] > 0 and tp.SWEEPS["windowed"] == tp.SWEEPS["exact_final_dual"] == 0
    dt = np.linalg.norm(windowed[:3, 3] - exact[:3, 3])
    rot = float(t_se3.rot_angle_deg(torch.from_numpy(windowed[:3, :3]), torch.from_numpy(exact[:3, :3])))
    assert dt < 0.06 and rot < 2.0, (dt, rot)
    assert aligner.av_depth_residual < t_lc.MAX_DEPTH_RESIDUAL and not aligner.ill_posed


def _seed(frames, cand, new):
    """The loop closer's dense seed of (cand, new): the PbMap pose through
    the sphere-frame conjugation."""
    lc = t_lc.LoopClosure360(None, device="cpu")
    assert lc.registerer.register_pbmap(frames[cand][0], frames[new][0], 25, PLANAR_3DOF)
    return (lc.rot_offset @ lc.registerer.get_pose() @ np.linalg.inv(lc.rot_offset)).astype(np.float32)


def test_full_coverage_raises_when_the_kernel_cannot_run(monkeypatch):
    """No fallback: on a tensor that is not on the CPU the FULL gather
    launches the kernel or raises — a failed build or launch never turns
    into the plain version. (A meta tensor stands in for a CUDA one here.)"""
    from rgbd360_torch.kernels import build

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(tw, "warp_gather_batched_multi_plain", lambda *a, **k: pytest.fail("fell back"))
    planes = torch.zeros((1, 16, 8, 256), device="meta")
    rc = torch.zeros((1, 16, 256), dtype=torch.int32, device="meta")
    active = torch.ones((1, 16, 256), dtype=torch.bool, device="meta")
    tw.reset_launch_counts()

    def no_build(verbose=False):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load_library", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tw.warp_gather_batched_multi(planes, rc, rc, active, anchors=tw.FULL)
    # through a full-coverage sweep, as the loop closer's refinement runs it
    xyz = torch.zeros((1, 16 * 256, 3), device="meta")
    valid = torch.ones((1, 16 * 256), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tp.fused_sweep_sphere(xyz[..., 0], planes, (16, 256), xyz, valid, torch.eye(4, device="meta")[None],
                              tp.PHOTO_DEPTH, two_pass=True, windowed=True)

    class Lib:
        @staticmethod
        def rgbd360_warp_gather(*args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(build, "load_library", lambda verbose=False: Lib())
    with pytest.raises(RuntimeError, match="launch failed: cudaError_t 700"):
        tw.warp_gather_batched_multi(planes, rc, rc, active, anchors=tw.FULL)
    assert tw.LAUNCHES["warp_gather_batched_multi"] == 0


def test_relocalizer_on_carried_pbmaps_matches_jax(frames):
    """A map of kf 0 and 1 and the query kf 2, the PbMaps carried across:
    the same keyframe newest-first, the same pose and information."""

    class Holder:
        def __init__(self, planes):
            self.planes = planes

    j_world = JMap()
    for k in (0, 1):
        j_world.add_keyframe(frames[k][1], np.eye(4, dtype=np.float32))
    t_world = convert.map_from_numpy(j_world, [Holder(convert.pbmap_from_numpy(frames[k][1].planes)) for k in (0, 1)])
    query_j = frames[2][1]
    query_t = Holder(convert.pbmap_from_numpy(query_j.planes))
    hit_j = j_reloc.Relocalizer360(j_world).relocalize(query_j)
    reloc_t = t_reloc.Relocalizer360(t_world, device="cpu")
    hit_t = reloc_t.relocalize(query_t)
    assert hit_j is not None and hit_t is not None
    assert hit_t[0] == hit_j[0] == reloc_t.reloc_kf == 1  # newest first
    np.testing.assert_allclose(hit_t[1], hit_j[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(hit_t[2], hit_j[2], rtol=1e-6, atol=0)
    # a frame without planes, or a map of plane-less keyframes: nothing
    assert reloc_t.relocalize(Holder(None)) is None
    assert t_reloc.Relocalizer360(convert.map_from_numpy(JMap(), []), device="cpu").relocalize(query_t) is None


def test_prefilter_on_room_planes_matches_jax_and_bounds_the_matcher(frames):
    """The batched prefilter on the room's plane sets: counts equal, areas
    within 1e-6 relative, and a relaxation of the exact matcher."""
    ref = frames[2][1].planes
    cands = [frames[k][1].planes for k in (0, 1)]
    cfg = t_lc.RegisterRGBD360().matcher.config
    counts_t, areas_t = t_bm.prefilter_candidates(
        convert.pbmap_from_numpy(ref), [convert.pbmap_from_numpy(c) for c in cands], cfg, PLANAR_3DOF, device="cpu")
    counts_j, areas_j = j_bm.prefilter_candidates(ref, cands, cfg, PLANAR_3DOF)
    np.testing.assert_array_equal(counts_t, counts_j)
    np.testing.assert_allclose(areas_t, areas_j, rtol=1e-6, atol=0)
    reg = t_lc.RegisterRGBD360()
    for k, cand in enumerate((0, 1)):
        assert reg.register_pbmap(frames[cand][0], frames[2][0], 25, PLANAR_3DOF)
        assert counts_t[k] >= len(reg.get_matched_planes()) > t_lc.MIN_MATCHES
        assert areas_t[k] >= reg.get_area_matched() - 1e-6


def test_entry_points_default_to_the_card(monkeypatch):
    """LoopClosure360 and Relocalizer360 (and the prefilter) run on cuda:0
    unless a device is named, and raise without a GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: t_lc.LoopClosure360(None), lambda: t_reloc.Relocalizer360(None),
                 lambda: t_bm.prefilter_candidates(t_bm.PbMap([]), [t_bm.PbMap([])], t_lc.RegisterRGBD360().matcher.config)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert t_lc.LoopClosure360(None).device == torch.device("cuda", 0)
    assert t_lc.LoopClosure360(None).aligner.device == torch.device("cuda", 0)
    assert t_reloc.Relocalizer360(None).device == torch.device("cuda", 0)
    assert t_lc.LoopClosure360(None, device="cpu").device.type == "cpu"

