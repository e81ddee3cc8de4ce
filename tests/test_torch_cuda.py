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
