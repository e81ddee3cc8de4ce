"""The CPU side of the spherical aligner's level loop (ops/photoicp.py,
_LevelLoop, through ops/level_graphs.py): the constants the loop makes on
the device keep their bits, the CPU runs every loop body uncaptured and
counts it so, one key's buffers and segments reused over other inputs equal
a fresh key's on the exact and both windowed routes, the gather's and the
planes' preallocated outputs, and the benchmark's reader of the graph
share. The card's side (captured bit-equal to uncaptured) is
tests/test_torch_cuda.py's test_graph_path_is_bit_equal_to_the_eager_path.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from bench360.lib.harness import Bench  # noqa: E402
from bench360.reference import linalg6 as frozen_linalg6  # noqa: E402
from bench360.reference import se3 as frozen_se3  # noqa: E402
from rgbd360_torch.ops import level_graphs, linalg6, se3  # noqa: E402
from rgbd360_torch.ops import photoicp as tp  # noqa: E402
from rgbd360_torch.ops import warp_gather as tw  # noqa: E402
from rgbd360_torch.parallel.batch import align_batch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _systems(seed, n=48):
    """SPD systems plus ill-posed ones: rank deficient, negative definite,
    non-finite, zero, and pivots under the eps floor."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(n, 20, 6)).astype(np.float32)
    H = np.einsum("nki,nkj->nij", J, J).astype(np.float32)
    H[0, 5, :] = H[0, :, 5] = 0.0
    H[1] = -H[1]
    H[2, 3, 3] = np.nan
    H[3] = 0.0
    H[4] *= np.float32(1e-36)  # pivots below 1e-30: sqrt(max(s, eps))
    return torch.from_numpy(H), torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))


@pytest.mark.parametrize("fn", ["cholesky6", "solve6_sym", "spd_well_posed"])
def test_linalg6_keeps_its_bits_with_eps_made_by_a_fill(fn):
    """cholesky6's eps is a fill on the tensors' device now, not an upload
    from pageable memory: the same bits as the frozen copy of the code
    before it (bench360/reference/linalg6.py)."""
    H, b = _systems(7)
    if fn == "cholesky6":
        (L, ok), (L_f, ok_f) = linalg6.cholesky6(H), frozen_linalg6.cholesky6(H)
        got = [ok] + [L[i][j] for i in range(6) for j in range(i + 1)]
        want = [ok_f] + [L_f[i][j] for i in range(6) for j in range(i + 1)]
    elif fn == "solve6_sym":
        got, want = linalg6.solve6_sym(H, b), frozen_linalg6.solve6_sym(H, b)
    else:
        got, want = [linalg6.spd_well_posed(H, 1.0)], [frozen_linalg6.spd_well_posed(H, 1.0)]
    assert len(got) == len(want)
    for a, f in zip(got, want):
        assert torch.equal(_bits(a), _bits(f))


@pytest.mark.parametrize("pseudo", [True, False])
def test_exp_se3_keeps_its_bits_with_the_bottom_row_made_on_the_device(pseudo):
    """se3._to_pose's [0, 0, 0, 1] row comes from torch.eye on the device:
    exp_se3 and inverse give the frozen copy's bits."""
    rng = np.random.default_rng(11)
    xi = rng.normal(scale=0.6, size=(64, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-7  # the Taylor branch
    xi = torch.from_numpy(xi)
    pose = se3.exp_se3(xi, pseudo=pseudo)
    assert torch.equal(_bits(pose), _bits(frozen_se3.exp_se3(xi, pseudo=pseudo)))
    assert torch.equal(_bits(se3.inverse(pose)), _bits(frozen_se3.inverse(pose)))
    assert torch.equal(pose[:, 3], torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(64, 4))


def _small_pairs(b=2, h=80, w=480):
    g = np.load(os.path.join(ROOT, "tests", "golden", "pair_1_10.npz"))
    rows = np.linspace(0, g["gray_src_u8"].shape[0] - 1, h).astype(int)
    cols = np.linspace(0, g["gray_src_u8"].shape[1] - 1, w).astype(int)
    img = lambda key, scale: torch.from_numpy(
        np.stack([g[key][np.ix_(rows, cols)].astype(np.float32) * scale] * b))
    return (img("gray_src_u8", 1 / 255.0), img("depth_src_mm", 0.001), img("gray_trg_u8", 1 / 255.0),
            img("depth_trg_mm", 0.001), torch.eye(4).expand(b, 4, 4).contiguous())


def test_the_cpu_runs_every_loop_body_op_by_op_and_counts_it():
    """photoicp.GRAPHS on the CPU: no capture, no replay, every loop body
    an eager one; a second align of the same shapes too (graphs are the
    CUDA path's); reset_sweep_counts() clears the group."""
    args = _small_pairs()
    tp.reset_sweep_counts()
    assert tp.GRAPHS == {"captures": 0, "replays": 0, "eager_bodies": 0}
    first = align_batch(*args, n_levels=2)
    second = align_batch(*args, n_levels=2)
    assert tp.GN["iterations"] > 0
    assert tp.GRAPHS == {"captures": 0, "replays": 0, "eager_bodies": tp.GN["iterations"]}
    for field in tp.AlignResult._fields:
        assert torch.equal(_bits(getattr(first, field)), _bits(getattr(second, field)))
    tp.reset_sweep_counts()
    assert set(tp.GRAPHS.values()) == {0}


def test_the_loop_takes_graphs_only_on_a_cuda_device():
    assert level_graphs.use_cuda_graphs(torch.device("cuda", 0))
    assert not level_graphs.use_cuda_graphs(torch.device("cpu"))


def _kept_keys(monkeypatch):
    """Keep each key's loop from its second use, as the card does, but
    uncaptured. Returns the devices of the keys made so far."""
    made = []

    def capture(device):
        made.append(device)
        return level_graphs.Segments(tp.GRAPHS)

    monkeypatch.setattr(level_graphs, "use_cuda_graphs", lambda device: True)
    monkeypatch.setattr(tp, "GRAPH_CACHE", level_graphs.GraphCache(tp.GRAPHS, capture=capture))
    return made


@pytest.mark.parametrize("route", ["exact", "windowed", "full_coverage"])
def test_one_key_s_buffers_equal_a_fresh_key_over_other_inputs(monkeypatch, route):
    """align_batch at 2 levels on inputs A, A, B, A through the cache: the
    first on fresh keys, the others on one key a level, made at the second
    and reused. Every AlignResult field equals the same input's align
    through fresh keys (the CPU's route) bit for bit, and so do SWEEPS,
    GN's counts and GRAPHS; on the windowed routes (forced, as the dry run
    forces them) the gather runs between the segments, into the key's
    buffers."""
    if route != "exact":
        monkeypatch.setattr(tp, "_use_warp_kernel", lambda shape, device: True)
    a = _small_pairs(h=40, w=240)
    inputs = {"A": a, "B": (a[2], a[3], a[0], a[1], a[4])}

    def align(name):
        tp.reset_sweep_counts()
        res = align_batch(*inputs[name], n_levels=2, full_coverage=route == "full_coverage")
        gn = {k: v for k, v in tp.GN.items() if k not in ("host_ns", "wait_ns")}
        return res, (gn, dict(tp.SWEEPS), dict(tp.GRAPHS))

    fresh = {name: align(name) for name in "AB"}
    assert fresh["A"][1][1][route] > 0 and fresh["A"][1][0]["iterations"] > 0
    made = _kept_keys(monkeypatch)
    for k, name in enumerate("AABA"):
        res, counts = align(name)
        want, want_counts = fresh[name]
        for field in tp.AlignResult._fields:
            assert torch.equal(_bits(getattr(res, field)), _bits(getattr(want, field))), (k, name, field)
        assert counts == want_counts, (k, name)
    assert len(made) == 2


@pytest.mark.parametrize("variant", ["mean", "full"])
def test_the_gather_writes_into_a_given_pair(variant):
    """warp_gather_batched(_multi)'s ``out``: the plain versions' result,
    bit for bit, in the caller's buffers, which the call returns."""
    rng = np.random.default_rng(3)
    b, h, w = 2, 16, 256
    planes = torch.from_numpy(rng.normal(size=(b, h, 8, w)).astype(np.float32))
    r = torch.from_numpy(np.clip(np.mgrid[0:h, 0:w][0] + rng.integers(-2, 3, (b, h, w)), 0, h - 1).astype(np.int32))
    c = torch.from_numpy(((np.mgrid[0:h, 0:w][1] + rng.integers(-9, 10, (b, h, w))) % w).astype(np.int32))
    active = torch.from_numpy(rng.random((b, h, w)) < 0.8)
    out = (torch.full((b, 8, h, w), 7.0), torch.zeros((b, h, w), dtype=torch.bool))
    if variant == "full":
        want = tw.warp_gather_batched_multi(planes, r, c, active, anchors=tw.FULL)
        got = tw.warp_gather_batched_multi(planes, r, c, active, anchors=tw.FULL, out=out)
    else:
        want = tw.warp_gather_batched(planes, r, c, active)
        got = tw.warp_gather_batched(planes, r, c, active, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(_bits(got[0]), _bits(want[0])) and torch.equal(got[1], want[1])


def test_pack_target_planes8_writes_into_a_given_buffer():
    src = tp.build_pyramid_set(*_small_pairs()[:2], 2, is_target=False, sphere_seam_mask=True)
    trg = tp.build_pyramid_set(*_small_pairs()[2:4], 2, is_target=True, sphere_seam_mask=True)
    level = tp.make_level_data(src, trg, 0)
    buf = torch.full((2, 80, 8, 480), 3.0)
    assert tp.pack_target_planes8(level, out=buf) is buf
    assert torch.equal(_bits(buf), _bits(tp.pack_target_planes8(level)))


def _reader(name):
    return Bench(os.path.join(ROOT, "BENCHMARK.json")).metric(name)


@pytest.mark.parametrize("name", ["photoicp.graph_share", "photoicp.graph_share.slam"])
def test_graph_share_reads_the_replayed_share_of_the_loop_bodies(name, monkeypatch):
    """The benchmark's reader: GN iterations less GRAPHS eager_bodies over
    the iterations, %; None with no iteration, or with no GRAPHS group (a
    program without graphs)."""
    reader = _reader(name)
    monkeypatch.setattr(tp, "GN", {"iterations": 40, "syncs": 45, "wait_ns": 1, "host_ns": 2})
    monkeypatch.setattr(tp, "GRAPHS", {"captures": 16, "replays": 37, "eager_bodies": 8})
    assert reader.read(None) == pytest.approx(80.0)
    monkeypatch.setattr(tp, "GRAPHS", {"captures": 0, "replays": 0, "eager_bodies": 40})
    assert reader.read(None) == 0.0
    monkeypatch.setattr(tp, "GN", {"iterations": 0, "syncs": 0, "wait_ns": 0, "host_ns": 0})
    assert reader.read(None) is None
    monkeypatch.setattr(tp, "GN", {"iterations": 40, "syncs": 45, "wait_ns": 1, "host_ns": 2})
    monkeypatch.delattr(tp, "GRAPHS")
    assert reader.read(None) is None


def test_graph_share_reads_a_cpu_align():
    tp.reset_sweep_counts()
    assert _reader("photoicp.graph_share").read(None) is None
    align_batch(*_small_pairs(), n_levels=2)
    assert _reader("photoicp.graph_share").read(None) == 0.0
