"""The shared CUDA-graph cache's bookkeeping (ops/level_graphs.py) on the
CPU, with a capture function injected in place of the card's: a key's first
use runs uncaptured, its second captures and is kept; a new key whose
bytes, foreseen per pair from the same spec, would pass the byte bound runs
uncaptured; release() drops a thread's keys; each thread keeps its own.
The uncaptured segments run in order, count eager bodies only and hold no
reference to their loop, so each align frees its loops. The card's
side (a capture's bytes; the bound over real aligns) is tests/test_torch_cuda.py's
test_graph_cache_stops_capturing_at_its_byte_bound.
"""

import threading
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from rgbd360_torch.ops import level_graphs as lg  # noqa: E402

CUDA = torch.device("cuda", 0)  # a key's device: the route asks no more of it


def _cache(nbytes=100):
    """A cache whose captures take ``nbytes`` each and touch no card; its
    loops are their Segments. Returns (cache, the devices captured for)."""
    made = []

    def capture(device):
        made.append(device)
        return SimpleNamespace(captured=True, nbytes=nbytes)

    counts = {"captures": 0, "replays": 0, "eager_bodies": 0}
    return lg.GraphCache(counts, capture=capture), made


def _loop(cache, bsz, spec="L0", device=CUDA):
    return cache.loop(device, bsz, spec, lambda segments: segments)


def test_a_key_runs_uncaptured_first_then_captures_once_and_is_kept():
    cache, made = _cache()
    first = _loop(cache, 2)
    assert not first.captured and made == [] and cache.held_bytes() == 0
    second = _loop(cache, 2)
    assert second.captured and made == [CUDA] and cache.held_bytes() == 100
    assert _loop(cache, 2) is second and made == [CUDA]
    # another key of the same spec and another spec: each its own first use
    assert not _loop(cache, 3).captured and not _loop(cache, 2, "L1").captured
    # off a CUDA device nothing is kept or captured
    cpu = torch.device("cpu")
    assert not any(_loop(cache, 2, device=cpu).captured for _ in range(3))
    assert made == [CUDA] and cache.held_bytes() == 100


def test_a_new_key_past_the_bound_runs_uncaptured(monkeypatch):
    """With 100 bytes held by a key of 2 pairs (50 a pair foreseen for its
    spec) and a bound of 150: 4 pairs of that spec would take 300, so they
    never capture though the bound is not reached; 1 pair takes 150 and
    captures; then a spec with nothing foreseen is refused, the bound
    passed."""
    monkeypatch.setattr(lg, "GRAPH_BYTES_PER_THREAD", 150)
    cache, made = _cache()
    _loop(cache, 2)
    assert _loop(cache, 2).captured
    assert not any(_loop(cache, 4).captured for _ in range(3))
    assert not _loop(cache, 1).captured and _loop(cache, 1).captured
    assert cache.held_bytes() == 200 and len(made) == 2
    assert not any(_loop(cache, 2, "L1").captured for _ in range(3))
    assert _loop(cache, 2).captured and len(made) == 2


def test_release_drops_the_thread_s_keys():
    cache, made = _cache()
    _loop(cache, 2)
    kept = _loop(cache, 2)
    cache.release()
    assert cache.held_bytes() == 0
    assert not _loop(cache, 2).captured
    again = _loop(cache, 2)
    assert again.captured and again is not kept and len(made) == 2 and cache.held_bytes() == 100


def test_each_thread_keeps_its_own_keys():
    """Two threads use the same key twice each: each captures its own,
    and each holds only its own bytes."""
    cache, made = _cache()
    seen, errors = {}, []

    def use(name):
        try:
            loops = [_loop(cache, 2) for _ in range(3)]
            seen[name] = ([s.captured for s in loops], loops[1] is loops[2], cache.held_bytes())
        except BaseException as exc:
            errors.append(exc)
            raise

    threads = [threading.Thread(target=use, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert seen == {k: ([False, True, True], True, 100) for k in range(2)}
    assert made == [CUDA, CUDA] and cache.held_bytes() == 0


def test_uncaptured_segments_run_in_order_count_eager_bodies_and_hold_no_loop():
    """Uncaptured, a replay calls its group's functions on the loop in
    order; only a loop body counts (an eager body); and the Segments keep
    no reference to their loop, so a loop is freed when dropped, without
    the cyclic collector."""
    import gc
    import weakref

    counts = {"captures": 0, "replays": 0, "eager_bodies": 0}

    class Loop:
        def __init__(self, segments):
            self.calls, self.segments = [], segments
            segments.record(self, [[Loop.one, Loop.two], [Loop.three]], [torch.zeros(4)])

        def one(self):
            self.calls.append(1)

        def two(self):
            self.calls.append(2)

        def three(self):
            self.calls.append(3)

    loop = Loop(lg.Segments(counts))
    loop.segments.replay(1, loop)
    loop.segments.replay(0, loop)
    assert loop.calls == [3, 1, 2] and not loop.segments.captured and loop.segments.nbytes == 0
    loop.segments.count(body=False)
    loop.segments.count(body=True)
    assert counts == {"captures": 0, "replays": 0, "eager_bodies": 1}
    gc.disable()
    try:
        ref = weakref.ref(loop)
        del loop
        assert ref() is None
    finally:
        gc.enable()


def test_each_aligner_s_uncaptured_loops_are_freed_when_the_align_returns():
    """On the CPU every level's loop is made anew and uncaptured: none
    outlives its align, with the cyclic collector off."""
    import gc

    import test_torch_rig_batch as rig_batch
    from rgbd360_torch.ops import photoicp, photoicp_pinhole
    from rgbd360_torch.parallel.batch import align_batch, align_batch_rig
    from test_torch_gn_graphs import _small_pairs

    pairs = _small_pairs(h=40, w=240)
    rig = [torch.stack([rig_batch._pair(1)[j]]) for j in range(4)]
    rts, k = torch.from_numpy(rig_batch.RTS.astype("float32")), torch.from_numpy(rig_batch.K)
    loops = (photoicp._LevelLoop, photoicp_pinhole._LevelLoop)
    gc.collect()
    gc.disable()
    try:
        photoicp.reset_sweep_counts()
        photoicp_pinhole.reset_sweep_counts()
        align_batch(*pairs, n_levels=2)
        align_batch_rig(*rig, rts, k, torch.eye(4)[None], n_levels=2)
        assert photoicp.GN["iterations"] > 0 and photoicp_pinhole.GN["iterations"] > 0
        assert not [o for o in gc.get_objects() if type(o) in loops]
    finally:
        gc.enable()
