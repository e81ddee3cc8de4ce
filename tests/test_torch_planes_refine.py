"""The plane refinement's growth loop (ops/planes_seg.py::grow_labels) on
the CPU: the plain host loop against an independent scalar transcription of
its rule, on crafted scenes, and its ``planes_seg.REFINE`` counts.

The scenes' points and planes lie on a lattice of 1/64 m with axis-aligned
normals, so every fit test is exact in f32 and f64 alike and its residual is
a whole number of lattice steps: 1/64 = 0.0156 fits the 0.02 m threshold,
2/64 = 0.0313 does not. tests/test_torch_cuda.py holds the card's kernel to
the plain loop bit for bit on the same scenes (and on float scenes, where
the rounding of the fit matters). The file imports no jax.
"""

import zlib

import numpy as np
import pytest
import torch

from rgbd360_torch.ops import planes_seg
from rgbd360_torch.utils import timing

STEP = 1.0 / 64.0
THR = planes_seg.DISTANCE_THRESHOLD


def _blank(s, h, w, rng):
    """Every pixel SHUT-like garbage: unlabelled, invalid, with random
    planes that a grow must never read (only a labelled pixel's plane is a
    candidate's)."""
    return dict(
        lab=np.full((s, h, w), -1, np.int32),
        n=rng.normal(size=(s, h, w, 3)).astype(np.float32),
        d=rng.normal(size=(s, h, w)).astype(np.float32),
        static=np.zeros((s, h, w), bool),
        valid=np.zeros((s, h, w), bool),
        p=np.zeros((s, h, w, 3), np.float32),
    )


def _on_plane_z(sc, where, z):
    """Points (x, y, z) on the lattice at the pixels ``where``, valid."""
    s_i, y_i, x_i = np.nonzero(where)
    sc["p"][s_i, y_i, x_i] = np.stack([x_i * STEP, y_i * STEP, np.full(len(x_i), z)], -1)
    sc["valid"][where] = True


def _source(sc, where, label, normal, d):
    sc["lab"][where] = label
    sc["n"][where] = normal
    sc["d"][where] = d


def refine_scene(name):
    """(inputs of grow_labels as numpy arrays, max_sweeps or None)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    z_up = (0.0, 0.0, 1.0)
    if name == "contested":
        # 3 x 7: label 2 on column 0 and label 9 on column 6, both on z = 1;
        # row 0 and 2 open on that plane (column 3 is reached by both in the
        # same round: the largest label wins); row 1 two steps off (no fit)
        sc = _blank(1, 3, 7, rng)
        _on_plane_z(sc, np.ones((1, 3, 7), bool), 1.0)
        sc["p"][0, 1, 1:6, 2] = 1.0 + 2 * STEP
        left, right = np.zeros((1, 3, 7), bool), np.zeros((1, 3, 7), bool)
        left[..., 0] = True
        right[..., 6] = True
        _source(sc, left, 2, z_up, 1.0)
        _source(sc, right, 9, z_up, 1.0)
        sc["p"][0, 2, 1:6, 2] = 1.0 + STEP  # one step off: still fits
        return sc, None
    if name == "static_and_nan":
        # 5 x 6: a model region (label 1) on column 0; a non-model region
        # (label 4, grows_static) in the middle, which neither grows nor is
        # absorbed; a NaN pixel (invalid, p = 0) on row 2, never labelled;
        # the pixels behind it are reached round the other rows
        sc = _blank(1, 5, 6, rng)
        _on_plane_z(sc, np.ones((1, 5, 6), bool), 2.0)
        src = np.zeros((1, 5, 6), bool)
        src[..., 0] = True
        _source(sc, src, 1, z_up, 2.0)
        stat = np.zeros((1, 5, 6), bool)
        stat[0, 1:4, 3] = True
        sc["static"][stat] = True  # lab_grow is -1 there: refine's final select restores 4
        sc["valid"][0, 2, 1] = False
        sc["p"][0, 2, 1] = 0.0
        return sc, None
    if name == "idle_sensor":
        # two sensors: the first grows for several rounds, the second has
        # nothing to grow (labelled, static or invalid pixels only)
        sc = _blank(2, 4, 9, rng)
        _on_plane_z(sc, np.ones((2, 4, 9), bool), 1.5)
        src = np.zeros((2, 4, 9), bool)
        src[0, :, 0] = True
        src[1, :, :4] = True
        _source(sc, src, 7, z_up, 1.5)
        sc["static"][1, :, 4:6] = True
        sc["valid"][1, :, 6:] = False
        sc["p"][1, :, 6:] = 0.0
        return sc, None
    if name == "corridor_cut":
        # a 1 x 40 corridor that needs 39 growing rounds, cut at 5
        sc = _blank(1, 1, 40, rng)
        _on_plane_z(sc, np.ones((1, 1, 40), bool), 1.0)
        src = np.zeros((1, 1, 40), bool)
        src[0, 0, 0] = True
        _source(sc, src, 0, z_up, 1.0)
        return sc, 5
    if name == "lattice":
        # 3 sensors of 16 x 20 in blocks of 4 x 4, each on one of three
        # axis-aligned planes and each a labelled region (model or not),
        # open pixels (0-2 steps off their plane) or invalid; open blocks
        # grow from model blocks of their plane, contested where two meet
        s, h, w = 3, 16, 20
        sc = _blank(s, h, w, rng)
        axes = np.eye(3, dtype=np.float32)
        planes = [(int(rng.integers(3)), float(rng.integers(32, 96)) * STEP) for _ in range(3)]
        kind = rng.choice(4, size=(s, h // 4, w // 4), p=[0.3, 0.1, 0.5, 0.1])  # model, static, open, invalid
        for si in range(s):
            for by in range(h // 4):
                for bx in range(w // 4):
                    blk = np.zeros((s, h, w), bool)
                    blk[si, by * 4:(by + 1) * 4, bx * 4:(bx + 1) * 4] = True
                    axis, dd = planes[rng.integers(3)]
                    k = kind[si, by, bx]
                    _s, y_i, x_i = np.nonzero(blk)
                    pts = np.stack([x_i * STEP, y_i * STEP, np.full(len(x_i), 1.0)], -1)
                    pts[:, axis] = dd + rng.integers(-2, 3, len(x_i)) * STEP * (k == 2)
                    sc["p"][blk] = 0.0 if k == 3 else pts
                    sc["valid"][blk] = k != 3
                    if k == 0:
                        _source(sc, blk, int(rng.integers(0, h * w)), axes[axis], dd)
                    elif k == 1:
                        sc["static"][blk] = True
        return sc, None
    raise KeyError(name)


REFINE_SCENES = ["contested", "static_and_nan", "idle_sensor", "corridor_cut", "lattice"]


def grow_args(sc, device="cpu"):
    keys = ("lab", "n", "d", "static", "valid", "p")
    return [torch.from_numpy(np.ascontiguousarray(sc[k])).to(device) for k in keys]


def reference_grow(sc, thr, max_sweeps):
    """The growth rule pixel by pixel, in f64, rounds synchronous: (labels,
    rounds run)."""
    lab, n, d = sc["lab"].copy(), sc["n"].astype(np.float64), sc["d"].astype(np.float64)
    p = sc["p"].astype(np.float64)
    s, h, w = lab.shape
    rounds = 0
    for _ in range(max_sweeps):
        rounds += 1
        new_lab, new_n, new_d = lab.copy(), n.copy(), d.copy()
        for si in range(s):
            for y in range(h):
                for x in range(w):
                    if lab[si, y, x] >= 0 or sc["static"][si, y, x] or not sc["valid"][si, y, x]:
                        continue
                    best = -1
                    for yy, xx in ((y + 1, x), (y - 1, x), (y, x + 1), (y, x - 1)):
                        if not (0 <= yy < h and 0 <= xx < w):
                            continue
                        cand = lab[si, yy, xx]
                        if cand > best and abs(n[si, yy, xx] @ p[si, y, x] - d[si, yy, xx]) < thr:
                            best = cand
                            new_n[si, y, x], new_d[si, y, x] = n[si, yy, xx], d[si, yy, xx]
                    new_lab[si, y, x] = best
        grew = (new_lab != lab).any()
        lab, n, d = new_lab, new_n, new_d
        if not grew:
            break
    return lab, rounds


@pytest.mark.parametrize("name", REFINE_SCENES)
def test_plain_growth_loop_follows_the_rule_and_counts_its_rounds(name):
    sc, max_sweeps = refine_scene(name)
    want, want_rounds = reference_grow(sc, THR, max_sweeps or sc["lab"].shape[1] * sc["lab"].shape[2])
    before = timing.counters()["planes_seg.REFINE"]
    got, rounds = planes_seg.grow_labels(*grow_args(sc), THR, max_sweeps)
    after = timing.counters()["planes_seg.REFINE"]
    np.testing.assert_array_equal(got.numpy(), want)
    assert rounds == want_rounds
    assert after["host_loop"] - before["host_loop"] == 1
    assert after["host_rounds"] - before["host_rounds"] == rounds
    assert after["kernel"] == before["kernel"]


def test_scenes_exercise_the_rule():
    """What each crafted scene is for, read off the reference."""
    lab, rounds = reference_grow(*(lambda sc: (sc[0], THR, 21))(refine_scene("contested")))
    assert lab[0, 0].tolist() == [2, 2, 2, 9, 9, 9, 9] and lab[0, 2].tolist() == lab[0, 0].tolist()
    assert lab[0, 1, 1:6].tolist() == [-1] * 5 and rounds == 4
    sc, _ = refine_scene("static_and_nan")
    lab, _r = reference_grow(sc, THR, 30)
    assert (lab[sc["static"]] == -1).all() and lab[0, 2, 1] == -1
    assert (lab[0, :, 4:] == 1).all()
    sc, _ = refine_scene("idle_sensor")
    lab, rounds = reference_grow(dict(sc, **{k: sc[k][1:] for k in sc}), THR, 36)
    assert rounds == 1
    sc, cut = refine_scene("corridor_cut")
    lab, rounds = reference_grow(sc, THR, cut)
    assert rounds == cut and lab[0, 0].tolist() == [0] * 6 + [-1] * 34
    assert reference_grow(sc, THR, 40)[1] == 40
    sc, _ = refine_scene("lattice")
    lab, rounds = reference_grow(sc, THR, 16 * 20)
    assert rounds >= 4 and ((lab >= 0) & (sc["lab"] < 0)).sum() > 50


def test_refine_plane_labels_runs_the_plain_loop_on_the_cpu():
    """refine_plane_labels on the CPU: one plain loop, no kernel, the rounds
    counted; the static labels restored by its final select."""
    rng = np.random.default_rng(3)
    h, w = 12, 16
    xyz = np.stack(list(np.meshgrid(np.arange(w) * STEP, np.arange(h) * STEP, indexing="xy")) + [np.ones((h, w))], -1)
    xyz = xyz.astype(np.float32)[None].repeat(2, 0)
    xyz[0, 5, 5] = np.nan
    labels = np.full((2, h, w), -1, np.int32)
    labels[:, :, :7] = 0  # a model region (>= 80 pixels)
    labels[1, :3, 12:] = 12  # a non-model region (12 pixels)
    labels[:, 6, 3] = -1
    labels[0, 5, 5] = -1
    xyz[:, :, 10] += rng.normal(0, 1e-3, size=(2, h, 3)).astype(np.float32)
    timing.reset_counts(planes_seg.REFINE)
    out = planes_seg.refine_plane_labels(torch.from_numpy(labels), torch.from_numpy(xyz))
    counts = dict(planes_seg.REFINE)
    assert counts["kernel"] == 0 and counts["host_loop"] == 1 and counts["host_rounds"] == w - 6
    out = out.numpy()
    assert (out[1, :3, 12:] == 12).all() and out[0, 5, 5] == -1
    assert (out[0][np.isfinite(xyz[0]).all(-1)] == 0).all()
    few = planes_seg.refine_plane_labels(torch.from_numpy(labels), torch.from_numpy(xyz), max_sweeps=2)
    assert planes_seg.REFINE["host_rounds"] == counts["host_rounds"] + 2
    assert few.numpy()[0, 0].tolist() == [0] * 9 + [-1] * 7
