"""The correctness check's control and the faults that need a whole loop,
on the card, at each cell's own size.

The control: the reference computed one precision below what the
configurations state (float32 matmuls in TF32, the pose graph in float32;
reference/api.py) stands in the program's place; every other step of a run
is as the benchmark runs it, with a short window at the cell's own load.
The faults, planted in the program: the loop closer's batched refinement
skipped (it returns no closure), and the pose graph's optimization
returning its state unchanged. Every such run must come out not correct.
The readings each seed gives are the upper readings the limits in
bench360/workloads/ were set from (PERF.md).

    python -m pytest bench360/tests/test_bench360_control.py -m cuda -s
"""

import contextlib
import io
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench360.lib import harness  # noqa: E402

CELLS = ["pair360.track-b8", "slam360.loop40", "slam360.arc20", "pair360.lc-b8"]
SEEDS = [2_147_483_700, 3_000_000_001, 4_100_000_003]
# long enough for one whole session of the SLAM cells, whose loop closer's
# batched refinements and trajectory the check judges
WINDOW_S = {"pair360": 5, "slam360.loop40": 30, "slam360.arc20": 12}


def window_s(cell: str) -> int:
    return WINDOW_S.get(cell, WINDOW_S.get(cell.split(".")[0]))


def bench_run(cell: str, seed: int, control: bool = False) -> dict:
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control and the faults run at the cells' own size on a CUDA device")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(window_s(cell)),
                          "--trace", "0"], bench_json=os.path.join(ROOT, "BENCHMARK.json"), control=control)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    line = bench_run(cell, seed, control=True)
    print(f"control {cell} seed {seed}: {json.dumps(line['checks'])}")
    assert line["correct"] is False


def _skip_refine_batch(monkeypatch):
    from rgbd360_torch.core.loop_closure import LoopClosure360

    monkeypatch.setattr(LoopClosure360, "_refine_batch", lambda self, new_kf, survivors: [])


def _graph_unchanged(monkeypatch):
    from rgbd360_torch.core.graph_optimizer import GraphOptimizer

    monkeypatch.setattr(GraphOptimizer, "optimize_graph", lambda self, iterations=10, lam=1e-6: 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,fault", [
    ("slam360.loop40", _skip_refine_batch),
    ("slam360.loop40", _graph_unchanged),
    ("slam360.arc20", _graph_unchanged),
])
def test_a_fault_of_a_whole_loop_is_not_correct(monkeypatch, cell, fault, seed):
    fault(monkeypatch)
    line = bench_run(cell, seed)
    print(f"fault {fault.__name__} {cell} seed {seed}: {json.dumps(line['checks'])}")
    assert line["correct"] is False
