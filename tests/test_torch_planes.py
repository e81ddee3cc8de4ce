"""The plane layer of the port (rgbd360_torch/ops/{pinhole,bilateral,normals,
planes_seg,plane_stats}.py, core/plane_extraction.py, the plane half of
core/frame360.py) against the JAX package, on the CPU.

Inputs: room captures through the construction-spec rig
(tools/synthetic_rig.py: seeded CLAMS models within +-0.2%, the room's walls,
floor, ceiling and two pillars, about 12 planes per frame), the same .bin
files read by both packages. Where a stage is compared alone, both get the
same inputs (JAX's output of the stage before).

Tolerances:
  * backproject_organized, downsample_median2: equal;
  * fast_bilateral_z: within 8 ulp, NaN pattern equal (the splat's second
    matmul sums in another order than XLA's dot; measured at most 7 ulp);
  * organized_normals: within 1e-5, NaN pattern equal (the integral images
    follow XLA's cumsum association bit for bit; measured 1.8e-7);
  * segment_planes on the same inputs, and through the whole chain
    (undistorted depth -> labels): equal;
  * refine_plane_labels, on the same inputs and through the chain (frames
    1-3): refined labels may differ at no more than 0.05% of the pixels, and
    each such pixel is unlabeled before the refinement and absorbed, in one
    package, into a line-like region (f64 eigengap lambda2 - lambda3 <
    1e-4 lambda1: its f32 model normal is any direction across the line,
    and torch's and XLA's f32 acos/cos, an ulp apart, pick different ones).
    (Measured on frames 2-3: 7 and 40 pixels, absorbed by line-like regions
    of 87-120 pixels with eigengaps of 9e-6 to 1.7e-5 lambda1.) This is
    chip_smoke.refine_differences, the rule the card-vs-CPU phase applies.
  * sensor_plane_stats on the same inputs: the same label_id set and order,
    counts, sums, means, covariances, histograms equal; the reported normal,
    eigenvalues and curvature of rows with >= MIN_INLIERS members and a
    well-posed fit (eigengap lambda2 - lambda3 >= 1e-3 lambda1) within 1e-4,
    1e-6 relative to lambda1, and 1e-5. (A line-like region's smallest
    eigenvector is any direction across the line; the f32 trig solver then
    returns one of them, a different one for an ulp of acos.) The hull
    candidate mask equal but at <= 0.01% of the pixels (through the whole
    chain, per-sensor candidate counts within 2%);
  * get_planes (both need_inliers settings, frame 1): the same plane count,
    order and member counts; normals within 1e-4, d within 1 mm, hull areas
    within 1% (measured 4.6e-7, 4.6e-7 m and 9e-8). On every frame of the
    6-frame sequence: the same, but for member counts (within the pixels
    whose refined labels differ) and for a plane that one package keeps and
    the other drops, which must be a line-like region's (see
    test_get_planes_on_every_frame);
  * group_planes / merge_planes on the same local planes: the same merges.
"""

import copy
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rgbd360_torch  # noqa: E402,F401  (sets the matmul precision)
from rgbd360_torch.core import frame360 as t_frame  # noqa: E402
from rgbd360_torch.core import pbmap as t_pbmap  # noqa: E402
from rgbd360_torch.core import plane_extraction as t_pe  # noqa: E402
from rgbd360_torch.io.calib import Calib360 as TCalib  # noqa: E402
from rgbd360_torch.ops import bilateral as t_bil  # noqa: E402
from rgbd360_torch.ops import normals as t_nrm  # noqa: E402
from rgbd360_torch.ops import pinhole as t_pin  # noqa: E402
from rgbd360_torch.ops import plane_stats as t_st  # noqa: E402
from rgbd360_torch.ops import planes_seg as t_seg  # noqa: E402
from rgbd360_tpu.core import frame360 as j_frame  # noqa: E402
from rgbd360_tpu.core import pbmap as j_pbmap  # noqa: E402
from rgbd360_tpu.core import plane_extraction as j_pe  # noqa: E402
from rgbd360_tpu.io.calib import Calib360 as JCalib  # noqa: E402
from rgbd360_tpu.ops import bilateral as j_bil  # noqa: E402
from rgbd360_tpu.ops import normals as j_nrm  # noqa: E402
from rgbd360_tpu.ops import pinhole as j_pin  # noqa: E402
from rgbd360_tpu.ops import plane_stats as j_st  # noqa: E402
from rgbd360_tpu.ops import planes_seg as j_seg  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

FRAMES = 6
T = torch.from_numpy
V = jax.vmap


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("planes"))
    calib_root, seq = os.path.join(d, "calib"), os.path.join(d, "seq")
    rts = rig.write_calib_root(calib_root)
    rig.write_sequence(seq, rts, frames=FRAMES, loops=0.1 * FRAMES / 6)
    return calib_root, seq


@pytest.fixture(scope="module")
def calibs(dataset):
    return TCalib.load(dataset[0]), JCalib.load(dataset[0])


def _path(dataset, n):
    return os.path.join(dataset[1], f"sphere_images_{n}.bin")


def _frames(dataset, calibs, n):
    """(port frame on the CPU, JAX frame), both built from capture n."""
    return (t_frame.Frame360(calibs[0], n, "cpu").build(_path(dataset, n)),
            j_frame.Frame360(calibs[1], n).build(_path(dataset, n)))


@pytest.fixture(scope="module")
def stages(dataset, calibs):
    """JAX's per-stage outputs on frame 1, the inputs of the stage tests."""
    _ft, fj = _frames(dataset, calibs, 1)
    depth, rgb = np.asarray(fj.depth_undistorted_m), np.asarray(fj.rgb)
    xyz = np.asarray(V(j_pin.backproject_organized)(jnp.asarray(depth)))
    x2, rgb2 = [np.asarray(a) for a in V(j_pin.downsample_median2)(jnp.asarray(xyz), jnp.asarray(rgb))]
    zf = np.asarray(V(j_bil.fast_bilateral_z)(jnp.asarray(x2[..., 2])))
    xyz2 = np.concatenate([x2[..., :2], zf[..., None]], axis=-1)
    normals = np.asarray(V(j_nrm.organized_normals)(jnp.asarray(xyz2)))
    pre = np.asarray(V(j_seg.segment_planes)(jnp.asarray(xyz2), jnp.asarray(normals)))
    labels = np.asarray(V(j_seg.refine_plane_labels)(jnp.asarray(pre), jnp.asarray(xyz2), jnp.asarray(normals)))
    return dict(depth=depth, rgb=rgb, xyz=xyz, x2=x2, rgb2=rgb2, xyz2=xyz2, normals=normals, pre=pre, labels=labels)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_backproject_and_median_downsample_equal_jax(stages):
    d = stages["depth"].copy()
    d[0, :4] = 0.2  # below the valid range
    d[1, :, :6] = 12.0  # beyond it
    want = np.asarray(V(j_pin.backproject_organized)(jnp.asarray(d)))
    got = t_pin.backproject_organized(T(d)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    xyz = want.copy()
    xyz[2, 10:14, 10:14] = np.nan  # an all-invalid block keeps its (NaN) center
    xyz[3, 20, 20, 2] = 5.5  # a sample outside (0.3, 5.0) leaves its block
    x2_t, rgb2_t = t_pin.downsample_median2(T(xyz), T(stages["rgb"]))
    x2_j, rgb2_j = V(j_pin.downsample_median2)(jnp.asarray(xyz), jnp.asarray(stages["rgb"]))
    np.testing.assert_array_equal(x2_t.numpy().view(np.int32), np.asarray(x2_j).view(np.int32))
    np.testing.assert_array_equal(rgb2_t.numpy(), np.asarray(rgb2_j))
    assert x2_t.shape == (8, 120, 160, 3) and np.isnan(x2_t.numpy()[2, 5, 5]).all()


def test_bilateral_within_ulps_of_jax(stages):
    z = stages["x2"][..., 2]
    got = t_bil.fast_bilateral_z(T(z.copy())).numpy()
    want = np.asarray(V(j_bil.fast_bilateral_z)(jnp.asarray(z)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert _ulps(got[fin], want[fin]).max() <= 8
    assert np.abs(got[fin] - z[fin]).max() > 1e-4  # the filter acts


@pytest.mark.parametrize("shape", [(120, 160), (300, 4), (17, 3), (5, 2), (600, 2)])
def test_integral_image_cumsum_equals_xla(shape):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    for axis in (0, 1):
        want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=axis))(jnp.asarray(x)))
        np.testing.assert_array_equal(t_nrm._cumsum_xla(T(x), axis).numpy(), want)


def test_normals_within_1e5_of_jax(stages):
    got = t_nrm.organized_normals(T(stages["xyz2"])).numpy()
    want = stages["normals"]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert 0.5 < np.isfinite(want).all(-1).mean() < 1.0
    assert np.nanmax(np.abs(got - want)) < 1e-5


def test_cos_threshold_is_jax_f32_cosine():
    want = np.asarray(jax.jit(lambda: jnp.cos(j_seg.ANGULAR_THRESHOLD))())
    assert np.float32(t_seg.cos_threshold()).view(np.int32) == want.view(np.int32)
    assert float(np.float32(t_seg.cos_threshold())) == t_seg.cos_threshold()


def test_segment_and_refine_equal_jax_on_the_same_inputs(stages):
    xyz2, normals = T(stages["xyz2"]), T(stages["normals"])
    pre = t_seg.segment_planes(xyz2, normals)
    assert pre.dtype == torch.int32
    np.testing.assert_array_equal(pre.numpy(), stages["pre"])
    labels = t_seg.refine_plane_labels(pre, xyz2, normals).numpy()
    assert (labels != stages["labels"]).mean() <= 5e-4
    _refine_differences_sit_on_the_limit(stages["xyz2"], stages["pre"], labels, stages["labels"])
    grown = (stages["labels"] >= 0) & (stages["pre"] < 0)
    assert grown.sum() > 100  # the refinement absorbs pixels here
    # min_inliers 20 takes the full-bin model path (top-KP would need 961 > 512 slots)
    few = t_seg.refine_plane_labels(pre, xyz2, normals, min_inliers=20).numpy()
    want_few = np.asarray(V(lambda lab, x: j_seg.refine_plane_labels(lab, x, None, min_inliers=20))(
        jnp.asarray(stages["pre"]), jnp.asarray(stages["xyz2"])))
    assert (few != want_few).mean() <= 5e-4
    _refine_differences_sit_on_the_limit(stages["xyz2"], stages["pre"], few, want_few)
    assert ((few >= 0) & (labels < 0)).sum() > 0  # smaller regions grow too
    # the host-loop backstop: one sweep stops short of the fixed point
    one = t_seg.segment_planes(xyz2, normals, max_sweeps=1).numpy()
    want_one = np.asarray(V(lambda x, n: j_seg.segment_planes(x, n, max_sweeps=1))(
        jnp.asarray(stages["xyz2"]), jnp.asarray(stages["normals"])))
    np.testing.assert_array_equal(one, want_one)


def test_top_k_ties_go_to_the_lower_index():
    vals = torch.tensor([[3.0, 5.0, 3.0, 0.0, 5.0, 0.0, 0.0]])
    v, i = t_seg.top_k_stable(vals, 5)
    jv, ji = jax.lax.top_k(jnp.asarray(vals.numpy()), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _refine_differences_sit_on_the_limit(xyz2, pre, lab_t, lab_j):
    """Every pixel the two refinements label differently is unlabeled before
    the refinement and absorbed into a line-like region by one of them: the
    rule of chip_smoke.refine_differences (see the module docstring), the
    one the card-vs-CPU phase applies."""
    import chip_smoke

    assert (pre[lab_t != lab_j] == -1).all()  # absorptions, refine-only
    assert chip_smoke.refine_differences(xyz2, pre, lab_t, lab_j) == 0


def test_refine_differences_explains_each_pixel(stages):
    """The rule counts pixels, not patches: a pixel a well-posed region
    absorbed, or one labeled before the refinement, stays unexplained beside
    explained ones."""
    import chip_smoke

    pre, labels = stages["pre"], stages["labels"]
    grown = (labels >= 0) & (pre < 0)
    wall = np.bincount(labels[grown]).argmax()  # the region that absorbs most: a wall
    s, r, c = np.argwhere(grown & (labels == wall))[0]
    other = labels.copy()
    other[s, r, c] = -1  # a well-posed region's absorption undone
    assert chip_smoke.refine_differences(stages["xyz2"], pre, labels, other) == 1
    s2, r2, c2 = np.argwhere(pre >= 0)[0]
    other[s2, r2, c2] = -1  # a segment-stage pixel relabeled
    assert chip_smoke.refine_differences(stages["xyz2"], pre, labels, other) == 2


# frames 1-4: on frames 5 and 6 a few segment-stage labels differ through
# the chain too (2 and 1 pixels), each an edge on the distance threshold
# (test_chain_segment_labels_differ_only_on_the_distance_threshold);
# test_get_planes_on_every_frame bounds their effect on the planes
@pytest.mark.parametrize("n", range(1, 5))
def test_labels_through_the_whole_chain(dataset, calibs, n):
    ft, fj = _frames(dataset, calibs, n)
    np.testing.assert_array_equal(ft.depth_undistorted_m.numpy(), np.asarray(fj.depth_undistorted_m))
    xyz2, _rgb2, normals, pre, lab_t = [a.numpy() for a in t_pe._sensor_clouds(ft.depth_undistorted_m, ft.rgb)]
    lab_j = np.asarray(j_pe.build_sensor_clouds(fj.depth_undistorted_m, fj.rgb)[3])
    pre_j = np.asarray(V(j_seg.segment_planes)(jnp.asarray(xyz2), jnp.asarray(normals)))
    np.testing.assert_array_equal(pre, pre_j)
    assert (lab_t != lab_j).mean() <= 5e-4, (lab_t != lab_j).sum()
    _refine_differences_sit_on_the_limit(xyz2, pre, lab_t, lab_j)


def test_sensor_plane_stats_rows_match_jax(stages):
    args = [stages[k] for k in ("xyz2", "rgb2", "labels", "pre")]
    got = t_st.sensor_plane_stats(*map(T, args))
    want = V(j_st.sensor_plane_stats)(*map(jnp.asarray, args))
    w = {k: np.asarray(getattr(want, k)) for k in want._fields}
    g = {k: getattr(got, k).numpy() for k in got._fields}
    np.testing.assert_array_equal(g["label_id"], w["label_id"])
    np.testing.assert_array_equal(g["count"], w["count"])
    for k in ("labels", "mean", "cov", "hist", "sum_rgb", "mean_pre"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    ev = w["evals"]
    rows = (w["count"] >= t_st.MIN_INLIERS) & (ev[..., 1] - ev[..., 2] >= 1e-3 * ev[..., 0])
    assert 30 <= rows.sum() < rows.size  # planes and clutter on every sensor
    assert np.abs(g["normal"][rows] - w["normal"][rows]).max() < 1e-4
    scale = w["evals"][rows][:, :1]
    assert (np.abs(g["evals"][rows] - w["evals"][rows]) / scale).max() < 1e-6
    assert np.abs(g["curvature"][rows] - w["curvature"][rows]).max() < 1e-5
    assert (g["candidate"] != w["candidate"]).mean() <= 1e-4
    assert 0.01 < w["candidate"].mean() < 0.2
    # the hue bins (a floored modulo) on every byte combination's corners
    cube = np.stack(np.meshgrid(*[np.arange(0, 256, 15, dtype=np.uint8)] * 3, indexing="ij"), -1)
    np.testing.assert_array_equal(t_st._hue_bins(T(cube)).numpy(), np.asarray(j_st._hue_bins(jnp.asarray(cube))))


def test_stats_buffer_unpacks_like_jax(dataset, calibs):
    ft, fj = _frames(dataset, calibs, 1)
    for ship in (True, False):
        bt = t_pe.build_sensor_plane_stats(ft.depth_undistorted_m, ft.rgb, ship_labels=ship)
        assert bt.dtype == torch.uint8 and bt.dim() == 1
        bj = np.asarray(j_pe.build_sensor_plane_stats(fj.depth_undistorted_m, fj.rgb, ship_labels=ship))
        assert bt.numel() == bj.size
        ut = j_pe._unpack_stats_buffer(bt.numpy(), 120, 160, ship_labels=ship)
        uj = j_pe._unpack_stats_buffer(bj, 120, 160, ship_labels=ship)
        if ship:
            assert (ut[0] != uj[0]).mean() <= 5e-4  # labels: see the refinement's rule
        assert ut[2].dtype == np.float16 and (ut[4] <= t_pe.MAX_CANDIDATES).all()
        assert (np.abs(ut[4].astype(int) - uj[4]) <= 0.02 * uj[4]).all()  # candidate counts
        np.testing.assert_array_equal(ut[3][..., 0], uj[3][..., 0])  # label ids
        assert np.abs(ut[3][..., 1] - uj[3][..., 1]).max() <= 10  # counts
    cand = torch.tensor([[True, False, True, True], [False, False, False, True]])
    np.testing.assert_array_equal(t_pe.compact_candidate_indices(cand, 2).numpy(), [[0, 2], [3, 4]])


@pytest.mark.parametrize("need_inliers", [True, False])
def test_get_planes_matches_jax(dataset, calibs, need_inliers):
    ft, fj = _frames(dataset, calibs, 1)
    pt, pj = ft.get_planes(need_inliers=need_inliers), fj.get_planes(need_inliers=need_inliers)
    assert 8 <= len(pj) == len(pt)
    for a, b in zip(pt.planes, pj.planes):
        assert a.id == b.id and a.n_pts == b.n_pts
        assert np.abs(a.normal - b.normal).max() < 1e-4
        assert abs(a.d - b.d) < 1e-3
        assert abs(a.area_hull - b.area_hull) <= 0.01 * b.area_hull
        assert (a.inliers is None) == (not need_inliers)
        if need_inliers:
            np.testing.assert_array_equal(np.sort(a.inliers), np.sort(b.inliers))
    assert (ft.local_planes is None) == (not need_inliers)
    assert ft.get_planar_area() == pytest.approx(fj.get_planar_area(), rel=1e-3)
    assert ft.get_planar_area() > 40.0  # walls, floor and ceiling of the room


def plane_correspondence(port, jax_pb):
    """({JAX plane index: port plane index} over the planes two PbMaps share,
    matched in order: normals within 1e-2 and d within 1 cm; [the JAX
    planes the port lacks])."""
    match, extra = {}, []
    for j, q in enumerate(jax_pb.planes):
        p = port.planes[len(match)] if len(match) < len(port) else None
        if p is not None and np.abs(p.normal - q.normal).max() < 1e-2 and abs(p.d - q.d) < 1e-2:
            match[j] = len(match)
        else:
            extra.append(j)
    assert len(match) == len(port), "a port plane JAX lacks"
    return match, extra


def _line_like(xyz2, pre, s, region):
    """The f64 fit of a segment-stage region, and whether it is a line
    (chip_smoke.refine_differences' rule)."""
    import chip_smoke

    w, v = np.linalg.eigh(np.cov(xyz2[s][pre[s] == region].astype(np.float64).T, bias=True))
    return w[1] - w[0] < chip_smoke.LINE_LIKE_GAP * w[2], v[:, 2]


@pytest.mark.parametrize("n", range(1, FRAMES + 1))
def test_get_planes_on_every_frame(dataset, calibs, n):
    """get_planes(need_inliers=True) on every frame of the 6-frame sequence.

    The planes both packages keep agree as on frame 1 (normals within 1e-4,
    d within 1 mm, hull areas within 1%), but for member counts, which may
    differ by the pixels whose refined labels differ, and for a plane grown
    from one line-like segment-stage region: its reported normal is that
    region's f32 fit, any direction across the line, so normals and d are
    held within 1e-2 and 1 cm there (measured 1.2e-3 and 3.9 mm, a plane of
    196 pixels on frame 2).

    JAX may keep a plane the port drops (frame 5 here: 209 pixels on sensor
    4). Such a plane must come from a line-like region (measured eigengap
    4.5e-6 lambda1) whose two f32 fits are planes through the line with
    normals far apart: JAX's refinement absorbs pixels off the line into its
    plane and the hull passes the area filter, the port's hull does not.
    JAX itself gives that region yet another normal when its ops run one by
    one instead of jitted: the fit is decided by rounding, not by either
    package."""
    ft, fj = _frames(dataset, calibs, n)
    xyz2, _rgb2, _nrm, pre, lab_t = [a.numpy() for a in t_pe._sensor_clouds(ft.depth_undistorted_m, ft.rgb)]
    xyz2_j, rgb2_j, _nrm_j, lab_j = [np.asarray(a) for a in j_pe.build_sensor_clouds(fj.depth_undistorted_m, fj.rgb)]
    n_differ = int((lab_t != lab_j).sum())
    pt, pj = ft.get_planes(need_inliers=True), fj.get_planes(need_inliers=True)
    match, extra = plane_correspondence(pt, pj)
    assert len(pt) >= 8 and len(extra) <= 1
    hw = xyz2.shape[1] * xyz2.shape[2]

    def regions(plane):
        s = plane.inliers // hw
        return np.unique(np.stack([s, lab_j.reshape(8, hw)[s, plane.inliers % hw]], 1), axis=0)

    for j, i in match.items():
        a, b = pt.planes[i], pj.planes[j]
        regs = regions(b)
        loose = len(regs) == 1 and _line_like(xyz2, pre, *regs[0])[0]
        assert np.abs(a.normal - b.normal).max() < (1e-2 if loose else 1e-4)
        assert abs(a.d - b.d) < (1e-2 if loose else 1e-3)
        assert abs(a.area_hull - b.area_hull) <= 0.01 * b.area_hull
        assert abs(a.n_pts - b.n_pts) <= n_differ
    for j in extra:
        [(s, region)] = regions(pj.planes[j])
        line_like, line = _line_like(xyz2, pre, s, region)
        assert line_like
        fits = {}
        for name, pe, buf in (
            ("port", t_pe, t_pe.build_sensor_plane_stats(ft.depth_undistorted_m, ft.rgb).numpy()),
            ("jax", j_pe, np.asarray(j_pe.build_sensor_plane_stats(fj.depth_undistorted_m, fj.rgb))),
        ):
            _lab, cand_lab, cand_xyz, stats, _n = j_pe._unpack_stats_buffer(buf, *xyz2.shape[1:3])
            row = stats[s][stats[s][:, 0] == region]
            kept = pe._planes_from_stats(row, None, cand_lab[s], cand_xyz[s], int(s), hw)
            fits[name] = (row[0, 14:17].astype(np.float64), len(kept))
        (n_t, kept_t), (n_j, kept_j) = fits["port"], fits["jax"]
        assert abs(n_t @ line) < 1e-2 and abs(n_j @ line) < 1e-2  # planes through the line
        assert np.abs(n_t - n_j).max() > 0.1
        assert (kept_t, kept_j) == (0, 1)
        # JAX op by op on its own clouds
        nrm = V(j_nrm.organized_normals)(jnp.asarray(xyz2_j))
        pre_e = V(j_seg.segment_planes)(jnp.asarray(xyz2_j), nrm)
        lab_e = V(j_seg.refine_plane_labels)(pre_e, jnp.asarray(xyz2_j), nrm)
        eager = V(j_st.sensor_plane_stats)(jnp.asarray(xyz2_j), jnp.asarray(rgb2_j), lab_e, pre_e)
        n_e = np.asarray(eager.normal)[s][np.asarray(eager.label_id)[s] == region][0]
        assert np.abs(n_e - n_j).max() > 0.1


def test_group_and_merge_planes_make_the_same_merges(dataset, calibs):
    """The host fit is a copy: the same local planes (JAX's, frame 2) give
    the same cross-sensor groups and global merges in both packages."""
    _ft, fj = _frames(dataset, calibs, 2)
    _pb, local = j_pe.extract_frame_planes(fj, need_inliers=True)
    as_port = [[t_pbmap.Plane(**{f.name: copy.deepcopy(getattr(p, f.name)) for f in j_pbmap.dataclasses.fields(p)})
                for p in ps] for ps in local]
    got = t_pe.merge_planes(t_pe.group_planes(as_port))
    want = j_pe.merge_planes(j_pe.group_planes([[copy.deepcopy(p) for p in ps] for ps in local]))
    assert sum(map(len, local)) > len(want) >= 8  # planes seen by several sensors merged
    assert len(got) == len(want)
    for a, b in zip(got.planes, want.planes):
        assert a.n_pts == b.n_pts
        np.testing.assert_array_equal(np.sort(a.inliers), np.sort(b.inliers))
        np.testing.assert_array_equal(a.normal, b.normal)
        np.testing.assert_array_equal(a.hull, b.hull)


def test_planes_pipeline_threaded_equals_sequential(dataset, calibs):
    """planes_pipeline on the CPU: the threaded schedule yields the same
    plane sets as the sequential one and as get_planes, calls the hook on
    the caller's thread in frame order, and surfaces a source's exception."""
    frames = [_frames(dataset, calibs, n)[0] for n in (1, 2)]
    expected = [[(p.normal.copy(), p.n_pts) for p in t_pe.extract_frame_planes(f, need_inliers=False)[0].planes]
                for f in frames]

    def run(threaded):
        hooks, main = [], threading.get_ident()

        def hook(frame):
            assert threading.get_ident() == main
            hooks.append(frame.id)

        out = list(t_pe.planes_pipeline(iter([(1, frames[0]), (2, frames[1])]), pre_collect=hook, threaded=threaded))
        return out, hooks

    for threaded in (False, True):
        out, hooks = run(threaded)
        assert hooks == [1, 2] and [no for no, _ in out] == [1, 2]
        for (_, f), exp in zip(out, expected):
            assert f.local_planes is None
            assert [(p.n_pts) for p in f.planes.planes] == [n for _, n in exp]
            for p, (n, _) in zip(f.planes.planes, exp):
                np.testing.assert_array_equal(p.normal, n)

    def bad():
        yield 1, frames[0]
        raise KeyError("source failed")

    with pytest.raises(KeyError):
        list(t_pe.planes_pipeline(bad(), threaded=True))


def test_deferred_frames_take_the_fused_program(dataset, calibs):
    """sequence_frames(defer_device=True) marks raw frames; planes_pipeline
    runs build_device_fused on them: the same panorama, depth and planes as
    the step-by-step frame."""
    from rgbd360_torch.apps.common import sequence_frames

    step = _frames(dataset, calibs, 1)[0]
    step.get_planes(need_inliers=False)
    seq = sequence_frames(calibs[0], dataset[1], 1, 1, "cpu", defer_device=True)
    [(no, fused)] = list(t_pe.planes_pipeline(iter([next(seq)]), threaded=False))
    assert no == 1 and fused._deferred_build
    for name in ("sphere_rgb", "sphere_depth_mm", "sphere_gray", "depth_undistorted_m"):
        assert torch.equal(getattr(fused, name), getattr(step, name)), name
    assert [p.n_pts for p in fused.planes.planes] == [p.n_pts for p in step.planes.planes]


def test_build_sphere_cloud_matches_jax(dataset, calibs):
    ft, fj = _frames(dataset, calibs, 1)
    xyz_t, rgb_t = ft.build_sphere_cloud()
    xyz_j, rgb_j = fj.build_sphere_cloud()
    assert xyz_t.shape == (8 * 120 * 160, 3)
    np.testing.assert_array_equal(rgb_t, rgb_j)
    np.testing.assert_array_equal(np.isnan(xyz_t), np.isnan(xyz_j))
    np.testing.assert_allclose(xyz_t, xyz_j, rtol=0, atol=1e-5, equal_nan=True)  # bilateral z within ulps


def test_keyframe_round_trips_and_loads_across_packages(dataset, calibs, tmp_path):
    ft, fj = _frames(dataset, calibs, 1)
    ft.get_planes(need_inliers=False)
    fj.get_planes(need_inliers=False)
    ft.pose = np.diag([1.0, 2.0, 3.0, 1.0]).astype(np.float32)
    ft.node, ft.timestamp = 3, 123
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    ft.save(str(port_dir), 7)
    fj.save(str(jax_dir), 7)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))

    def same_planes(a, b):
        assert len(a) == len(b)
        for p, q in zip(a.planes, b.planes):
            assert p.id == q.id and p.n_pts == q.n_pts
            np.testing.assert_array_equal(p.normal, q.normal)
            np.testing.assert_array_equal(p.hull, q.hull)
            np.testing.assert_array_equal(p.hist_h, q.hist_h)

    back = t_frame.Frame360.load_keyframe(calibs[0], str(port_dir), 7, "cpu")
    same_planes(back.planes, ft.planes)
    assert torch.equal(back.sphere_rgb, ft.sphere_rgb) and torch.equal(back.sphere_depth_mm, ft.sphere_depth_mm)
    assert torch.equal(back.sphere_gray, ft.sphere_gray)
    assert back.node == 3 and back.timestamp == 123 and back.pose[1, 1] == 2.0
    assert back.sphere_cloud[0].shape == (320 * 1920, 3)
    # the port's keyframe in JAX, JAX's in the port
    in_jax = j_frame.Frame360.load_keyframe(calibs[1], str(port_dir), 7)
    same_planes(in_jax.planes, ft.planes)
    np.testing.assert_array_equal(in_jax.sphere_cloud[0], back.sphere_cloud[0])
    np.testing.assert_array_equal(np.asarray(in_jax.sphere_depth_mm), ft.sphere_depth_mm.numpy())
    in_port = t_frame.Frame360.load_keyframe(calibs[0], str(jax_dir), 7, "cpu")
    same_planes(in_port.planes, fj.planes)
    np.testing.assert_array_equal(in_port.sphere_rgb.numpy(), np.asarray(fj.sphere_rgb))
    with pytest.raises(RuntimeError, match="get_planes"):
        t_frame.Frame360(calibs[0], 1, "cpu").save_planes(str(tmp_path / "x.pbmap.npz"))


def test_entry_points_default_to_the_card(dataset, calibs, monkeypatch):
    """Frame360, RegisterPhotoICP, sequence_frames and load_keyframe run on
    cuda:0 unless a device is named, and raise when there is no GPU."""
    from rgbd360_torch.apps.common import sequence_frames
    from rgbd360_torch.core.register_photoicp import RegisterPhotoICP

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = [
        lambda: t_frame.Frame360(calibs[0]),
        lambda: RegisterPhotoICP(),
        lambda: next(sequence_frames(calibs[0], dataset[1], 1, 1)),
        lambda: t_frame.Frame360.load_keyframe(calibs[0], "unused", 1),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert t_frame.Frame360(calibs[0]).device == torch.device("cuda", 0)
    assert RegisterPhotoICP().device == torch.device("cuda", 0)
    assert t_frame.Frame360(calibs[0], 0, "cpu").device.type == "cpu"


# Segment-stage labels through the whole chain (depth -> labels), port
# against JAX, on the 6-frame sequence: pixels that differ, per frame
CHAIN_LABEL_DIFFERENCES = {1: 0, 2: 0, 3: 0, 4: 0, 5: 2, 6: 1}


@jax.jit
def _jax_chain_to_segments(depth, rgb):
    """JAX's build_sensor_clouds up to the segment stage, with its labels
    (the jitted function returns only the refined ones)."""

    def one(d, r):
        xyz2, _rgb2 = j_pin.downsample_median2(j_pin.backproject_organized(d), r)
        xyz2 = jnp.concatenate([xyz2[..., :2], j_bil.fast_bilateral_z(xyz2[..., 2])[..., None]], axis=-1)
        normals = j_nrm.organized_normals(xyz2)
        return xyz2, normals, j_seg.segment_planes(xyz2, normals)

    return V(one)(depth, rgb)


@pytest.mark.parametrize("n", range(1, FRAMES + 1))
def test_chain_segment_labels_differ_only_on_the_distance_threshold(dataset, calibs, n):
    """Where the segment-stage labels of the whole chain differ, port against
    JAX (frames 5 and 6: 2 and 1 pixels), one 4-connected edge decides it,
    and its predicate |d_a - d_b| < DISTANCE_THRESHOLD sits on the threshold:
    on one side in the port, on the other in JAX, each within 0.1 mm of
    0.02 m. The angle predicate of that edge agrees. The segmentation itself
    has no arithmetic difference: JAX's segment_planes on the port's clouds
    and normals gives the port's labels on every frame. The operands differ
    because the bilateral-filtered depth differs by a few ulps (its splat's
    matmul sums in torch's order, not XLA's dot's: test_bilateral_within_
    ulps_of_jax), which the normals' box sums carry to ~1e-4.

    Measured, margins |d_a - d_b| - 0.02 in metres (port / JAX):
      frame 5, sensor 0 (5, 29) - (4, 29): -1.86e-08 / +1.41e-06 (the port
        connects the pixel to region 669, JAX leaves it to region 829);
      frame 5, sensor 2 (34, 128) - (35, 128): +5.47e-06 / -7.34e-07 (JAX
        connects it to region 4353, the port leaves it to 5568);
      frame 6, sensor 5 (116, 110) - (116, 109): -4.66e-05 / +1.38e-05 (the
        port connects it to 18562, JAX leaves it to 18670)."""
    ft, fj = _frames(dataset, calibs, n)
    xyz2, _rgb2, normals, pre, _lab = [a.numpy() for a in t_pe._sensor_clouds(ft.depth_undistorted_m, ft.rgb)]
    xyz2_j, normals_j, pre_j = [np.asarray(a) for a in _jax_chain_to_segments(fj.depth_undistorted_m, fj.rgb)]
    built = j_pe.build_sensor_clouds(fj.depth_undistorted_m, fj.rgb)
    np.testing.assert_array_equal(xyz2_j, np.asarray(built[0]))  # the app's program, stage by stage
    np.testing.assert_array_equal(normals_j, np.asarray(built[2]))
    same_inputs = np.asarray(V(j_seg.segment_planes)(jnp.asarray(xyz2), jnp.asarray(normals)))
    np.testing.assert_array_equal(pre, same_inputs)
    differ = np.argwhere(pre != pre_j)
    assert len(differ) == CHAIN_LABEL_DIFFERENCES[n]
    cos_thr = t_seg.cos_threshold()

    def edge(x, nrm, a, b):
        """(normals' dot - cos threshold, |d_a - d_b| - distance threshold),
        as segment_planes computes them."""
        na, nb, pa, pb = (torch.from_numpy(v.astype(np.float32)) for v in (nrm[a], nrm[b], x[a], x[b]))
        dd = torch.abs(t_nrm.dot3(na, pa) - t_nrm.dot3(nb, pb))
        return float(t_nrm.dot3(na, nb)) - cos_thr, float(dd) - t_seg.DISTANCE_THRESHOLD

    for s, r, c in differ:
        deciding = []
        for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            r2, c2 = r + dr, c + dc
            if not (0 <= r2 < pre.shape[1] and 0 <= c2 < pre.shape[2]):
                continue
            (cos_t, dist_t), (cos_j, dist_j) = (edge(xyz2, normals, (s, r, c), (s, r2, c2)),
                                                edge(xyz2_j, normals_j, (s, r, c), (s, r2, c2)))
            if (cos_t > 0 and dist_t < 0) != (cos_j > 0 and dist_j < 0):
                deciding.append((cos_t, dist_t, cos_j, dist_j))
                # the angle agrees; the distance falls on either side of 0.02 m
                assert cos_t > 0 and cos_j > 0, (s, r, c, dr, dc, cos_t, cos_j)
                assert (dist_t < 0) != (dist_j < 0) and max(abs(dist_t), abs(dist_j)) < 1e-4, (dist_t, dist_j)
                # the operands: the filtered depth a few ulps apart
                assert _ulps(xyz2[s, r2, c2, 2:], xyz2_j[s, r2, c2, 2:]).max() <= 8
                assert np.abs(normals[s, r, c] - normals_j[s, r, c]).max() < 1e-3
        assert len(deciding) == 1, (s, r, c, deciding)
