"""The port's windowed warp gather (rgbd360_torch/ops/warp_gather.py)
against the JAX package's Pallas kernels run in interpret mode on the CPU.

The plain PyTorch version must equal the TPU kernel BIT FOR BIT, on the
gathered channels (compared as int32 bits, so -0.0, denormals and NaN
payloads count) and on the in-window mask, for every row policy and
anchor set, and for the single-buffer ``_kernel`` that
warp_gather_batched runs under PIPELINE_KERNEL = False. The CUDA kernel
is held to the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from rgbd360_torch.ops import warp_gather as tw  # noqa: E402
from rgbd360_tpu.ops import warp_gather as jw  # noqa: E402
# the scenes are shared with the jax-free card tests
import test_torch_cuda as ts  # noqa: E402
from test_torch_cuda import ANCHORS, SCENES, VARIANTS, assert_bit_exact, run_port, run_single  # noqa: E402


@pytest.fixture(scope="module")
def interpret_kernel():
    """Run the JAX package's pl.pallas_call in interpret mode, as
    tests/test_warp_kernel_interpret.py does."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl.pallas_call = patched
    jw.warp_gather_batched.clear_cache()
    jw.warp_gather_batched_multi.clear_cache()
    yield
    pl.pallas_call = orig
    jw.warp_gather_batched.clear_cache()
    jw.warp_gather_batched_multi.clear_cache()


@pytest.fixture()
def single_buffer(interpret_kernel, monkeypatch):
    """Both packages on the single-buffer route. JAX reads PIPELINE_KERNEL
    when it traces warp_gather_batched, so the jit cache is cleared on
    either side of the test: a stale trace would run the other kernel."""
    monkeypatch.setattr(jw, "PIPELINE_KERNEL", False)
    monkeypatch.setattr(tw, "PIPELINE_KERNEL", False)
    jw.warp_gather_batched.clear_cache()
    yield
    jw.warp_gather_batched.clear_cache()


def _run_jax(planes, r, c, active, variant):
    act = np.ones(r.shape, bool) if active is None else active
    args = (jnp.asarray(planes), jnp.asarray(r), jnp.asarray(c), jnp.asarray(act))
    if variant in ANCHORS:
        out, mask = jw.warp_gather_batched_multi(*args, anchors=ANCHORS[variant])
    else:
        out, mask = jw.warp_gather_batched(*args, row_policy=variant)
    return np.asarray(out), np.asarray(mask)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("scene", SCENES)
def test_plain_gather_bit_exact_vs_pallas_interpret(interpret_kernel, scene, variant):
    planes, r, c, active = ts.scene(scene)
    want = _run_jax(planes, r, c, active, variant)
    got = run_port(planes, r, c, active, variant)
    assert_bit_exact(got, want)
    mask = got[1]
    # the scenes exercise what they are named for
    if scene == "identity":
        assert mask.all()
    if scene == "two_band":
        # the row mean falls between the bands, min and max each take one
        # band, and the anchor sets take their union
        lo, hi = {"mean": (0.0, 0.1), "min": (0.4, 0.6), "max": (0.4, 0.6)}.get(variant, (0.95, 1.0))
        assert lo <= mask.mean() <= hi
    if scene == "empty_tiles":
        assert not mask[0, 0:8, 0:128].any() and not mask[1, 8:24, 128:256].any()
        assert not (mask & ~active).any()
    if scene == "denormals":
        bits = np.moveaxis(got[0][:, 2:6], 1, -1).view(np.int32)[mask]
        assert ((bits != 0) & (np.abs(bits) < 0x00800000)).any()  # a denormal arrived
        assert (bits == np.int32(-(2**31))).any()  # a -0.0 arrived as -0.0


@pytest.mark.parametrize("variant", ["mean", "max", "dual"])
def test_plain_gather_bit_exact_on_960_wide_wrap_level(interpret_kernel, variant):
    planes, r, c, active = ts.wide_scene()
    want = _run_jax(planes, r, c, active, variant)
    got = run_port(planes, r, c, active, variant)
    assert_bit_exact(got, want)
    assert got[1][1].mean() > 0.5  # the yawed pair is mostly covered


SINGLE_CASES = [(name, "mean") for name in SCENES] + [("wide", "mean"), ("wide", "max"), ("empty_tiles", "min")]


@pytest.mark.parametrize("scene,policy", SINGLE_CASES)
def test_single_buffer_plain_bit_exact_vs_pallas_interpret(single_buffer, scene, policy):
    """warp_gather_batched under PIPELINE_KERNEL = False runs the Pallas
    ``_kernel`` whatever the row policy, and ignores ``active`` (sparse in
    empty_tiles): the port's route and its plain version equal it bit for
    bit, on the scenes and on the 960-wide level."""
    planes, r, c, active = ts.wide_scene() if scene == "wide" else ts.scene(scene)
    want = _run_jax(planes, r, c, active, policy)
    before = dict(tw.LAUNCHES)
    assert_bit_exact(run_port(planes, r, c, active, policy), want)
    assert_bit_exact(run_single(planes, r, c, plain=True), want)
    assert tw.LAUNCHES == before  # no kernel launch on the CPU


def test_single_buffer_differs_from_pipelined_mean_pass():
    """The single-buffer pass is not the pipelined mean pass with every
    pixel active: its f32 accumulation (which flushes, as the TPU's and
    XLA-CPU's adds do) returns -0.0 and denormals as +0.0, channel 6 holds
    the gathered zero instead of the flag, and on the 960-wide level the
    half-padded last column tile places other row windows, because its
    edge-replicated pad pixels take part."""
    planes, r, c, _ = ts.scene("denormals")
    out_s, mask_s = run_single(planes, r, c, plain=True)
    out_p, mask_p = run_port(planes, r, c, None, "mean")
    np.testing.assert_array_equal(mask_s, mask_p)  # 256 wide: no pad column
    bits_s, bits_p = out_s.view(np.int32), out_p.view(np.int32)
    tiny = lambda b: (b & 0x7F800000) == 0  # +-0.0 and denormals
    assert (bits_p[:, 2:6][mask_p[:, None].repeat(4, 1)] == np.int32(-(2**31))).any()
    assert (tiny(bits_p) & (bits_p != 0))[:, :6].any()  # the pipelined pass keeps them
    np.testing.assert_array_equal(bits_s[tiny(bits_s)], 0)  # the single pass does not
    same = ~tiny(bits_p)
    np.testing.assert_array_equal(bits_s[:, :6][same[:, :6]], bits_p[:, :6][same[:, :6]])
    assert (out_p[:, 6][mask_p] == 1.0).all() and (out_s[:, 6] == 0.0).all()

    planes, r, c, _ = ts.wide_scene()
    _, mask_s = run_single(planes, r, c, plain=True)
    _, mask_p = run_port(planes, r, c, None, "mean")
    cols = np.nonzero(mask_s != mask_p)[2]
    assert cols.size > 100 and cols.min() >= 896  # only in the half-padded last tile


@pytest.mark.parametrize("policy", ["mean", "min", "max"])
@pytest.mark.parametrize("scene", ["seam_yaw", "two_band", "empty_tiles"])
def test_window_mask_reference_batched_matches_jax(scene, policy):
    """The port's batched window_mask_reference equals JAX's per pair, on
    the same target grid and on a smaller one with wrap off (a sensor image
    gathered into another grid)."""
    _planes_unused, r, c, active = ts.scene(scene)
    act_t = None if active is None else torch.from_numpy(active)
    got = tw.window_mask_reference(torch.from_numpy(r), torch.from_numpy(c), act_t, row_policy=policy).numpy()
    for i in range(r.shape[0]):
        a_j = None if active is None else jnp.asarray(active[i])
        want = np.asarray(jw.window_mask_reference(jnp.asarray(r[i]), jnp.asarray(c[i]), a_j, row_policy=policy))
        np.testing.assert_array_equal(got[i], want)
    # unbatched (H, W) form, wrap off, a target grid other than the index grid
    rr, cc = np.minimum(r[0], 19), np.minimum(c[0], 199)
    a0 = None if active is None else active[0]
    got = tw.window_mask_reference(
        torch.from_numpy(rr), torch.from_numpy(cc), None if a0 is None else torch.from_numpy(a0),
        row_policy=policy, target_shape=(20, 200), wrap=False,
    ).numpy()
    want = np.asarray(jw.window_mask_reference(
        jnp.asarray(rr), jnp.asarray(cc), None if a0 is None else jnp.asarray(a0),
        row_policy=policy, target_shape=(20, 200), wrap=False,
    ))
    np.testing.assert_array_equal(got, want)


def test_tile_origins_match_jax():
    _p, r, c, active = ts.scene("empty_tiles")
    args = (r, c, active, 256, 32, 512)
    for anchor in ("min", "max"):
        r0_t, c0_t = tw.tile_origins(*[torch.from_numpy(x) for x in args[:3]], *args[3:], anchor=anchor)
        r0_j, c0_j = jw._tile_origins(*[jnp.asarray(x) for x in args[:3]], *args[3:], anchor=anchor)
        np.testing.assert_array_equal(r0_t.numpy(), np.asarray(r0_j))
        np.testing.assert_array_equal(c0_t.numpy(), np.asarray(c0_j))
    assert tw.wrap_halo(960) == jw._wrap_halo(960) == 320
    assert [tw.wrap_halo(w) for w in (60, 120, 240, 480)] == [jw._wrap_halo(w) for w in (60, 120, 240, 480)]


def test_cpu_tensors_take_the_plain_version_and_bad_operands_raise():
    planes, r, c, active = ts.scene("two_band")
    before = dict(tw.LAUNCHES)
    got = run_port(planes, r, c, active, "mean")
    assert_bit_exact(got, run_port(planes, r, c, active, "mean", plain=True))
    assert tw.LAUNCHES == before  # no kernel launch on the CPU
    P, R, C = torch.from_numpy(planes), torch.from_numpy(r), torch.from_numpy(c)
    with pytest.raises(ValueError):
        tw.warp_gather_batched(P.double(), R, C)
    with pytest.raises(ValueError):
        tw.warp_gather_batched(P, R.long(), C)
    with pytest.raises(ValueError):
        tw.warp_gather_batched(P[:, :, :6], R, C)
    with pytest.raises(ValueError):
        tw.warp_gather_batched(P, R, C, row_policy="median")
    with pytest.raises(ValueError):
        tw.warp_gather_batched_multi(P, R, C, None)
