"""The port's RegisterPhotoICP facade against the JAX package's, and the
port's independence from JAX (it must import with jax unavailable)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.core.register_photoicp import RegisterPhotoICP as TorchRegister  # noqa: E402
from rgbd360_torch.ops import photoicp as tp  # noqa: E402
from rgbd360_torch.ops import se3 as t_se3  # noqa: E402
from rgbd360_torch.parallel.batch import align_batch  # noqa: E402
from rgbd360_tpu.core.register_photoicp import RegisterPhotoICP as JaxRegister  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "pair_1_10.npz")
ACCESSORS = ["get_optimal_pose", "get_hessian", "get_gradient"]
PROPERTIES = ["sso", "av_photo_residual", "av_depth_residual", "ill_posed", "num_iterations"]


@pytest.fixture(scope="module")
def frames():
    g = np.load(GOLDEN)
    # BGR made as gray x 3 converts back to the same gray exactly
    bgr = lambda key: np.repeat(g[f"gray_{key}_u8"][..., None], 3, axis=-1)
    return bgr("src"), g["depth_src_mm"], bgr("trg"), g["depth_trg_mm"]


def _run(make, frames, **align_kw):
    reg = make()
    reg.set_source_frame(frames[0], frames[1])
    reg.set_target_frame(frames[2], frames[3])
    pose = reg.align_frames360(**align_kw)
    return reg, pose


def test_facade_matches_jax_facade(frames):
    """Default facade (4 levels, PHOTO_CONSISTENCY) on both packages: same
    basin, finite entropy, accessors of equal shapes and dtypes."""
    reg_t, pose_t = _run(lambda: TorchRegister(device="cpu"), frames)
    reg_j, pose_j = _run(JaxRegister, frames)
    assert reg_t.n_pyr_levels == reg_j.n_pyr_levels == 4
    dt = np.linalg.norm(pose_t[:3, 3] - pose_j[:3, 3])
    rot = float(t_se3.rot_angle_deg(torch.from_numpy(pose_t[:3, :3]), torch.from_numpy(pose_j[:3, :3].astype(np.float32))))
    assert dt < 0.06 and rot < 2.0, (dt, rot)
    for name in ACCESSORS:
        a, b = getattr(reg_t, name)(), getattr(reg_j, name)()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.isfinite(a).all(), name
    for name in PROPERTIES:
        a, b = getattr(reg_t, name), getattr(reg_j, name)
        assert type(a) is type(b), name
        if isinstance(a, np.ndarray):
            assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(pose_t, reg_t.get_optimal_pose())
    ent_t, ent_j = reg_t.calc_entropy(), reg_j.calc_entropy()
    assert np.isfinite(ent_t) and abs(ent_t - ent_j) < 1.0, (ent_t, ent_j)
    assert abs(reg_t.sso - reg_j.sso) < 0.02
    assert reg_t.av_depth_residual == 0.0  # PHOTO_CONSISTENCY has no depth terms


def test_facade_equals_align_batch_on_the_same_pair(frames):
    """The facade is align_batch for one pair: PHOTO_DEPTH, 5 levels, the
    same pose bits and iteration signature."""
    reg = TorchRegister(n_pyr_levels=5, device="cpu")
    reg.set_source_frame(frames[0], frames[1])
    reg.set_target_frame(frames[2], frames[3])
    pose = reg.align_frames360(method=tp.PHOTO_DEPTH)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))[None]
    gray = lambda bgr: bgr[..., 0].astype(np.float32) * np.float32(1.0 / 255.0)  # gray_f32's scaling
    res = align_batch(
        t(gray(frames[0])), t(frames[1].astype(np.float32) * np.float32(0.001)),
        t(gray(frames[2])), t(frames[3].astype(np.float32) * np.float32(0.001)),
        torch.eye(4)[None],
    )
    np.testing.assert_array_equal(pose, res.pose[0].numpy())
    np.testing.assert_array_equal(reg.num_iterations, res.num_iterations[0].numpy())
    assert reg.av_depth_residual == float(res.av_depth_residual[0]) > 0
    assert reg.ill_posed is False
    assert reg.result.pose.shape == (1, 4, 4)


def test_pyramid_cache_is_lru_by_identity(frames):
    reg = TorchRegister(device="cpu")
    reg.set_target_frame(frames[2], frames[3])
    first = reg._trg
    reg.set_target_frame(frames[2], frames[3])
    assert reg._trg is first  # same arrays: cached
    reg.set_source_frame(frames[2], frames[3])
    assert reg._src is not first  # same arrays, other role: built anew
    for _ in range(reg._PYR_CACHE_SIZE - 2):  # fill the cache with fresh arrays
        reg.set_source_frame(frames[0].copy(), frames[1].copy())
        reg.set_target_frame(frames[2], frames[3])  # a hit keeps it newest
    assert len(reg._pyr_cache) == reg._PYR_CACHE_SIZE
    reg.set_target_frame(frames[2], frames[3])
    assert reg._trg is first  # LRU: the hot entry survived the evictions
    with pytest.raises(RuntimeError):
        TorchRegister(device="cpu").get_optimal_pose()


def test_port_imports_without_jax():
    """Every module of rgbd360_torch imports with jax made unimportable, and
    none of them pulls in rgbd360_tpu; nor does tools/synthetic_rig.py,
    which chip_smoke.py imports."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "before = set(sys.modules)\n"
        "import rgbd360_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(rgbd360_torch.__path__, 'rgbd360_torch.')]\n"
        "for n in names + ['tools.synthetic_rig']: importlib.import_module(n)\n"
        "new = set(sys.modules) - before\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib', 'rgbd360_tpu') for k in new), new\n"
        "print(' '.join(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 41  # ops (14), io (5), core (7), apps (2), utils (2), ...
    for n in ("io.native_loader", "core.frame360", "apps.odometry", "ops.stitch", "ops.undistort",
              "core.plane_extraction", "core.register_rgbd360", "ops.planes_seg", "io.ini"):
        assert f"rgbd360_torch.{n}" in names
