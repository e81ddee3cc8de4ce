"""The port's small ops (rgbd360_torch.ops se3, linalg6, image, sphere)
against the JAX package on the same numpy inputs.

se3 and linalg6 run on seeded random batches; image and sphere on the
bundled golden panoramas (tests/golden/pair_1_10.npz) at all five pyramid
levels. Both packages run on the CPU here.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd360_torch.ops import image as t_image  # noqa: E402
from rgbd360_torch.ops import linalg6 as t_linalg6  # noqa: E402
from rgbd360_torch.ops import se3 as t_se3  # noqa: E402
from rgbd360_torch.ops import sphere as t_sphere  # noqa: E402
from rgbd360_tpu.ops import image as j_image  # noqa: E402
from rgbd360_tpu.ops import linalg6 as j_linalg6  # noqa: E402
from rgbd360_tpu.ops import photoicp as j_photoicp  # noqa: E402
from rgbd360_tpu.ops import se3 as j_se3  # noqa: E402
from rgbd360_tpu.ops import sphere as j_sphere  # noqa: E402
from rgbd360_torch.ops import photoicp as t_photoicp  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pair_1_10.npz")

# f32 agreement of the se3 / linalg6 closed forms. rtol 1e-6 is a few ulp;
# atol 1e-6 covers entries that cancel towards 0 (e.g. 1 - cos(theta) at
# small theta, where a 1-ulp difference of cos between torch and XLA is a
# large relative error of a term whose absolute weight is tiny)
RTOL, ATOL = 1e-6, 1e-6


def _np(t):
    return t.detach().cpu().numpy()


def _ulp_diff(a, b):
    """Largest distance in units in the last place between two f32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # map the sign-magnitude bit order onto a monotone integer line
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _twists(seed, n=64):
    rng = np.random.default_rng(seed)
    xi = rng.normal(scale=0.6, size=(n, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-7  # the Taylor branch (theta < 1e-6)
    xi[8:16, 3:] *= 1e-3  # small angles: 1 - cos cancels
    return xi


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------


def test_skew_and_exp_so3_match_jax():
    xi = _twists(0)
    w = xi[:, 3:]
    np.testing.assert_array_equal(_np(t_se3.skew(torch.from_numpy(w))), np.asarray(j_se3.skew(jnp.asarray(w))))
    np.testing.assert_allclose(
        _np(t_se3.exp_so3(torch.from_numpy(w))), np.asarray(j_se3.exp_so3(jnp.asarray(w))), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("pseudo", [True, False])
def test_exp_se3_matches_jax(pseudo):
    xi = _twists(1)
    got = _np(t_se3.exp_se3(torch.from_numpy(xi), pseudo=pseudo))
    want = np.asarray(j_se3.exp_se3(jnp.asarray(xi), pseudo=pseudo))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if pseudo:  # the mrpt pseudo-exponential copies the translation verbatim
        np.testing.assert_array_equal(got[:, :3, 3], xi[:, :3])


def test_log_compose_inverse_angle_match_jax():
    rng = np.random.default_rng(2)
    # rotations away from 0 and pi, where arccos is well conditioned
    w = rng.normal(size=(32, 3)).astype(np.float32)
    w *= (rng.uniform(0.1, 2.5, size=(32, 1)) / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)
    xi = np.concatenate([rng.normal(size=(32, 3)).astype(np.float32), w], axis=1)
    pa = np.array(j_se3.exp_se3(jnp.asarray(xi)))
    pb = np.array(j_se3.exp_se3(jnp.asarray(xi[::-1].copy())))
    ta, tb = torch.from_numpy(pa), torch.from_numpy(pb)

    got = _np(t_se3.log_so3(ta[:, :3, :3]))
    want = np.asarray(jax.vmap(j_se3.log_so3)(jnp.asarray(pa[:, :3, :3])))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # arccos: cond ~ 1/sin(theta)
    np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)  # and it inverts exp_so3

    np.testing.assert_allclose(
        _np(t_se3.compose(ta, tb)), np.asarray(j_se3.compose(jnp.asarray(pa), jnp.asarray(pb))), rtol=RTOL, atol=ATOL
    )
    np.testing.assert_allclose(
        _np(t_se3.inverse(ta)), np.asarray(j_se3.inverse(jnp.asarray(pa))), rtol=RTOL, atol=ATOL
    )
    got = _np(t_se3.rot_angle_deg(ta[:, :3, :3], tb[:, :3, :3]))
    want = np.asarray(jax.vmap(j_se3.rot_angle_deg)(jnp.asarray(pa[:, :3, :3]), jnp.asarray(pb[:, :3, :3])))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)  # degrees through arccos


# ---------------------------------------------------------------------------
# linalg6
# ---------------------------------------------------------------------------


def _systems(seed, n=48):
    """SPD systems of moderate condition, plus ill-posed members: rank
    deficient, indefinite, non-finite, zero."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(n, 20, 6)).astype(np.float32)
    H = np.einsum("nki,nkj->nij", J, J).astype(np.float32)
    H[0, 5, :] = H[0, :, 5] = 0.0  # rank deficient
    H[1] = -H[1]  # negative definite
    H[2, 3, 3] = np.nan
    H[3] = 0.0
    b = rng.normal(size=(n, 6)).astype(np.float32)
    return H, b


def test_cholesky_solve_flags_match_jax():
    H, b = _systems(3)
    L_t, ok_t = t_linalg6.cholesky6(torch.from_numpy(H))
    L_j, ok_j = j_linalg6.cholesky6(jnp.asarray(H))
    np.testing.assert_array_equal(_np(ok_t), np.asarray(ok_j))
    assert not _np(ok_t)[:4].any() and _np(ok_t)[4:].all()
    ok = _np(ok_t)
    for i in range(6):
        for j in range(i + 1):
            np.testing.assert_allclose(_np(L_t[i][j])[ok], np.asarray(L_j[i][j])[ok], rtol=RTOL, atol=ATOL)

    x_t, sok_t = t_linalg6.solve6_sym(torch.from_numpy(H), torch.from_numpy(b))
    x_j, sok_j = j_linalg6.solve6_sym(jnp.asarray(H), jnp.asarray(b))
    np.testing.assert_array_equal(_np(sok_t), np.asarray(sok_j))
    np.testing.assert_allclose(_np(x_t)[ok], np.asarray(x_j)[ok], rtol=RTOL, atol=ATOL)
    # and it solves the system (the residual scales with the condition)
    res = np.einsum("nij,nj->ni", H[ok].astype(np.float64), _np(x_t)[ok]) - b[ok]
    assert np.abs(res).max() < 1e-3


@pytest.mark.parametrize("lam", [0.0, 1.0])
def test_spd_well_posed_matches_jax(lam):
    H, _ = _systems(4)
    got = _np(t_linalg6.spd_well_posed(torch.from_numpy(H), lam))
    want = np.asarray(j_linalg6.spd_well_posed(jnp.asarray(H), jnp.float32(lam)))
    np.testing.assert_array_equal(got, want)


def test_logdet_and_inverse_match_jax():
    H, _ = _systems(5)
    H = H[4:]  # SPD members only
    ld_t, ok_t = t_linalg6.logdet6_sym(torch.from_numpy(H))
    ld_j, ok_j = j_linalg6.logdet6_sym(jnp.asarray(H))
    np.testing.assert_array_equal(_np(ok_t), np.asarray(ok_j))
    np.testing.assert_allclose(_np(ld_t), np.asarray(ld_j), rtol=RTOL, atol=1e-5)
    inv_t, iok_t = t_linalg6.inv6_sym(torch.from_numpy(H))
    inv_j, iok_j = j_linalg6.inv6_sym(jnp.asarray(H))
    np.testing.assert_array_equal(_np(iok_t), np.asarray(iok_j))
    np.testing.assert_allclose(_np(inv_t), np.asarray(inv_j), rtol=RTOL, atol=ATOL)
    # calc_entropy is 0.5 * (6 (1 + log 2 pi) - log|H|) on both sides
    np.testing.assert_allclose(
        _np(t_photoicp.calc_entropy(torch.from_numpy(H))),
        np.asarray(jax.vmap(j_photoicp.calc_entropy)(jnp.asarray(H))),
        rtol=RTOL, atol=1e-5,
    )


# ---------------------------------------------------------------------------
# image
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_round_half_away_on_halves():
    k = np.arange(-6, 7, dtype=np.float32)
    x = np.concatenate([k + 0.5, k - 0.5, k, k + 0.49999997, k + 0.25]).astype(np.float32)
    got = _np(t_image.round_half_away(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, np.asarray(j_image.round_half_away(jnp.asarray(x))))
    halves = (k + 0.5).astype(np.float32)
    np.testing.assert_array_equal(got[: k.size], np.sign(halves) * np.ceil(np.abs(halves)))
    # torch.round rounds half to even, which differs on +-k.5
    assert (_np(torch.round(torch.from_numpy(halves))) != got[: k.size]).any()


def test_gray_conversion_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, size=(3, 40, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        _np(t_image.bgr_to_gray_u8(torch.from_numpy(img))), np.asarray(j_image.bgr_to_gray_u8(jnp.asarray(img)))
    )
    np.testing.assert_array_equal(
        _np(t_image.gray_f32(torch.from_numpy(img))), np.asarray(j_image.gray_f32(jnp.asarray(img)))
    )
    # a gray image stored as BGR converts back to itself exactly
    g = img[..., 0]
    np.testing.assert_array_equal(_np(t_image.bgr_to_gray_u8(torch.from_numpy(np.repeat(g[..., None], 3, -1)))), g)


@pytest.mark.parametrize("shape", [(21, 37), (40, 64)])
def test_pyr_down_and_depth_down_odd_sizes(shape):
    rng = np.random.default_rng(7)
    img = rng.random(shape).astype(np.float32)
    got = _np(t_image.pyr_down(torch.from_numpy(img)))
    want = np.asarray(j_image.pyr_down(jnp.asarray(img)))
    assert got.shape == want.shape == (shape[0] // 2, shape[1] // 2)  # floor sizes
    assert _ulp_diff(got, want) <= 1
    depth = (rng.random(shape) * 7.0).astype(np.float32)
    depth[rng.random(shape) < 0.2] = 0.0
    got = _np(t_image.depth_down_valid(torch.from_numpy(depth), 0.3, 6.0))
    want = np.asarray(j_image.depth_down_valid(jnp.asarray(depth), 0.3, 6.0))
    np.testing.assert_array_equal(got == 0, want == 0)
    # a mean of up to four positive samples: XLA picks the summation order
    # per shape, and two orders of four f32 terms differ by at most 2 ulp
    assert _ulp_diff(got, want) <= 2


@pytest.mark.parametrize("is_target", [False, True])
def test_pyramid_sets_match_jax_on_golden(golden, is_target):
    """Both pyramid builders at all 5 levels on the golden panoramas: the
    valid (nonzero-depth) masks equal, every value within 1 ulp (measured:
    bit-identical — the port keeps the operand order of each JAX sum)."""
    key = "trg" if is_target else "src"
    gray = golden[f"gray_{key}_u8"].astype(np.float32) / 255.0
    depth = golden[f"depth_{key}_mm"].astype(np.float32) * 0.001
    want = j_photoicp.build_pyramid_set(
        jnp.asarray(gray), jnp.asarray(depth), 5, is_target=is_target, sphere_seam_mask=True
    )
    got = t_photoicp.build_pyramid_set(
        torch.from_numpy(gray)[None], torch.from_numpy(depth)[None], 5, is_target=is_target, sphere_seam_mask=True
    )
    assert len(got) == len(want) == (6 if is_target else 2)
    for part_t, part_j in zip(got, want):
        for lv in range(5):
            a, b = _np(part_t[lv][0]), np.asarray(part_j[lv])
            assert a.shape == b.shape == (320 >> lv, 1920 >> lv)
            np.testing.assert_array_equal(a == 0, b == 0)
            assert _ulp_diff(a, b) <= 1
    if is_target:
        # the seam mask turns negative gradients into -0.0; the gather must
        # carry those bits (tests/test_torch_warp_gather.py)
        ggx0 = _np(got[2][0][0])
        assert (np.signbit(ggx0) & (ggx0 == 0)).sum() > 0


def test_raw_pyramid_builder_matches_jax(golden):
    bgr = np.repeat(golden["gray_trg_u8"][..., None], 3, -1)
    depth_mm = golden["depth_trg_mm"]
    want = j_photoicp.build_pyramid_set_raw(
        jnp.asarray(bgr), jnp.asarray(depth_mm), 3, is_target=True, sphere_seam_mask=True
    )
    got = t_photoicp.build_pyramid_set_raw(
        torch.from_numpy(bgr)[None], torch.from_numpy(depth_mm.astype(np.int32)).to(torch.uint16)[None],
        3, is_target=True, sphere_seam_mask=True,
    )
    for part_t, part_j in zip(got, want):
        for lv in range(3):
            assert _ulp_diff(_np(part_t[lv][0]), np.asarray(part_j[lv])) <= 1


# ---------------------------------------------------------------------------
# sphere
# ---------------------------------------------------------------------------

# torch's and XLA's CPU sin/cos may round differently by an ulp; the LUT
# point is a product of depth with sin/cos, so its coordinates may differ by
# a few ulp (measured on the golden levels: at most 3)
LUT_ULP = 4
# sphere_project rounds asin/atan2 onto the pixel grid: an ulp of difference
# flips an index only where the value sits on a rounding boundary (measured
# on the golden pair: 2 of 614,400 pixels at L0, none at L1-L4)
PROJECT_FLIP_FRACTION = 2e-5


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_sphere_lut_and_projection_match_jax(golden, level):
    depth = golden["depth_src_mm"].astype(np.float32) * 0.001
    depth_lv = np.array(j_image.build_depth_pyramid(jnp.asarray(depth), 5, 0.3, 6.0)[level])
    h, w = depth_lv.shape
    xyz_j, val_j = j_sphere.sphere_xyz_lut(jnp.asarray(depth_lv), 0.3, 6.0)
    xyz_t, val_t = t_sphere.sphere_xyz_lut(torch.from_numpy(depth_lv)[None], 0.3, 6.0)
    np.testing.assert_array_equal(_np(val_t)[0], np.asarray(val_j))
    assert _ulp_diff(_np(xyz_t)[0], np.asarray(xyz_j)) <= LUT_ULP

    # project through a small motion, from the same f32 points on both sides
    pose = np.asarray(golden["free_pose"], np.float32)
    p = (np.asarray(xyz_j) @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    d_j, r_j, c_j, in_j = [np.asarray(x) for x in j_sphere.sphere_project(jnp.asarray(p), h, w)]
    d_t, r_t, c_t, in_t = [_np(x)[0] for x in t_sphere.sphere_project(torch.from_numpy(p)[None], h, w)]
    assert r_t.dtype == c_t.dtype == np.int32
    assert _ulp_diff(d_t, d_j) <= 1
    flips = (r_t != r_j) | (c_t != c_j) | (in_t != in_j)
    assert flips.mean() <= PROJECT_FLIP_FRACTION, flips.sum()


def test_theta_wrap_column_is_dropped_not_wrapped():
    """atan2(+0, z<0) + pi == 2 pi lands on column W: out of bounds, as the
    reference drops it (RegisterPhotoICP.h:2684), on both packages."""
    h, w = 80, 480
    p = np.array([[0.0, 0.0, -2.0], [0.1, 0.0, -1.5], [0.0, 1e-9, -1.0]], np.float32)
    _d, r_t, c_t, in_t = [_np(x) for x in t_sphere.sphere_project(torch.from_numpy(p), h, w)]
    _d, r_j, c_j, in_j = [np.asarray(x) for x in j_sphere.sphere_project(jnp.asarray(p), h, w)]
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(in_t, in_j)
    assert (c_t[:2] == w).all() and not in_t[:2].any()
