"""Closed-loop batched registration of the reference's own sample pair
(captures 1 and 10, stitched by the reference: bench360/data/pair_1_10.npz,
a frozen copy of tests/golden/pair_1_10.npz's four panoramas) from noisy
seeds, through the program's align_batch: drivers/pairs.py's window,
imported, over a pool of perturbed guesses of the one pair.

Traffic parameters (bench360/workloads/<cell>.json):
  data          the .npz under bench360/ with gray_src_u8, gray_trg_u8
                (1920 x 320) and depth_src_mm, depth_trg_mm
  guesses       the pool's size: guesses drawn once from perturb_seed
  perturb_seed  the seed of the guesses
  perturb_deg, perturb_m  each guess is the identity (in the sphere frame)
                turned by Rz(c) Ry(b) Rx(a), a, b, c uniform in
                +-perturb_deg, and moved by t uniform in +-perturb_m per axis
  full_coverage, batch, warmup_batches, check_batches, trace_seconds,
  limits        as drivers/pairs.py

Each pair of the pool is the golden pair (the file's source and target)
with its own guess. The seed draws only the order of the
guesses (drivers/pairs.py's PairStream) and the sample the check compares,
so every seed does the same work. The panoramas become the aligner's
input as the program's tests feed it: gray u8 / 255 and depth mm * 0.001,
float32. The check re-runs a seeded sample of the window's batches with
the plain reference from the same arrays and guesses, and compares each
pair's pose, statistics, ill-posed flag and iterations per level.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bench360.drivers import pairs
from bench360.lib.compare import Worst, iter_gap, pose_gap, rel_gap
from bench360.reference import api as reference

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rot(axis: int, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    i, j = [k for k in range(3) if k != axis]
    m = np.eye(4)
    m[i, i] = m[j, j] = np.cos(a)
    m[i, j], m[j, i] = -np.sin(a), np.sin(a)
    return m


def perturbed_guesses(w: dict) -> np.ndarray:
    """(guesses, 4, 4) float32: the identity turned and moved by the
    traffic's seeded perturbations."""
    rng = np.random.default_rng(w["perturb_seed"])
    out = []
    for _ in range(w["guesses"]):
        a, b, c = rng.uniform(-w["perturb_deg"], w["perturb_deg"], 3)
        g = _rot(2, c) @ _rot(1, b) @ _rot(0, a)
        g[:3, 3] = rng.uniform(-w["perturb_m"], w["perturb_m"], 3)
        out.append(g)
    return np.stack(out).astype(np.float32)


def panoramas(w: dict, device) -> dict:
    """The pair's aligner inputs on ``device``: gray in [0, 1] and depth in
    metres, float32, (320, 1920) each."""
    data = np.load(os.path.join(BENCH_DIR, w["data"]))
    gray = lambda key: torch.from_numpy(data[key].astype(np.float32) / 255.0).to(device)
    metres = lambda key: torch.from_numpy(data[key].astype(np.float32) * 0.001).to(device)
    return {"gray_src": gray("gray_src_u8"), "depth_src": metres("depth_src_mm"),
            "gray_trg": gray("gray_trg_u8"), "depth_trg": metres("depth_trg_mm")}


class Driver(pairs.Driver):
    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        ctx, w = self.ctx, self.w
        self.pano = panoramas(w, ctx.device)
        self.guess_pool = perturbed_guesses(w)
        n = len(self.guess_pool)
        # the window of drivers/pairs.py indexes these: slot 0 the source, 1 the target
        self.gray = torch.stack([self.pano["gray_src"], self.pano["gray_trg"]])
        self.depth = torch.stack([self.pano["depth_src"], self.pano["depth_trg"]])
        self.src_idx = torch.zeros(n, dtype=torch.long, device=ctx.device)
        self.trg_idx = torch.ones(n, dtype=torch.long, device=ctx.device)
        self.guesses = torch.from_numpy(self.guess_pool).to(ctx.device)
        self.pool = [(1, 0)] * n
        ctx.note(f"set-up: the golden pair, {n} guesses within {w['perturb_deg']} deg and {w['perturb_m']} m")
        warm = pairs.PairStream(n, w["batch"], ctx.seed + 1)
        for _ in range(w["warmup_batches"]):
            self._batch(warm.next())

    def release(self) -> None:
        super().release()
        del self.pano

    # -- correctness ----------------------------------------------------------
    def check(self, control: bool = False) -> list:
        """The reference over a seeded sample of the window's batches (the
        one with the most Gauss-Newton iterations among them), at the
        window's batch, from the same arrays: each pair's pose, statistics,
        ill-posed flag (a disagreement reads inf) and iterations per level.
        ``control``: the reference one precision lower stands in the
        program's place."""
        ctx, w = self.ctx, self.w
        if not self.records:
            return []
        rng = np.random.default_rng(ctx.seed + 2)
        longest = max(range(len(self.records)), key=lambda k: self.records[k][1]["iters"].max(axis=0).sum())
        others = [k for k in range(len(self.records)) if k != longest]
        sample = [longest] + rng.choice(others, size=min(len(others), w["check_batches"] - 1), replace=False).tolist()
        pano = panoramas(w, ctx.device)
        limits = w["limits"]
        worst = Worst(*limits)
        for k in sample:
            idx, prog = self.records[k]
            b = len(idx)
            rep = lambda t: t[None].expand(b, -1, -1).contiguous()
            args = (rep(pano["gray_src"]), rep(pano["depth_src"]), rep(pano["gray_trg"]), rep(pano["depth_trg"]),
                    self.guess_pool[idx])
            ref = reference.align(*args, full_coverage=w["full_coverage"])
            if control:
                with reference.precision(lower=True):
                    prog = reference.align(*args, full_coverage=w["full_coverage"])
            for i in range(b):
                if bool(prog["ill"][i]) != bool(ref["ill"][i]):
                    worst.add("align_t_mm", float("inf"))
                t_mm, r_deg = pose_gap(prog["pose"][i], ref["pose"][i])
                worst.add("align_t_mm", t_mm)
                worst.add("align_r_deg", r_deg)
                worst.add("align_iters", iter_gap(prog["iters"][i], ref["iters"][i]))
                for key in ("error", "av_photo", "av_depth", "sso"):
                    worst.add("align_stats", rel_gap(prog[key][i], ref[key][i]))
        return [(name, value, limits[name]) for name, value in worst.values.items()]
