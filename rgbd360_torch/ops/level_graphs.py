"""How an aligner's level loop is captured into CUDA graphs and kept.

On a CUDA device a level loop is host issue: hundreds of small kernels a
body, each a few microseconds on the card. So each aligner
(ops/photoicp.py, ops/photoicp_pinhole.py) cuts its loop into segments, and
on the card replays them from CUDA graphs. A key is (device, B, the level's
spec) in one thread, with its graphs and the buffers they read and write.
A graph runs the kernels of its segments on the same shapes, so a replay is
bit for bit the segments run uncaptured, which is the only other route: the
CPU, a key's first use and a key past the byte bound take it.

Per thread and aligner, a key's first use runs uncaptured (it warms the
allocator, cuBLAS and the kernel's library), its second captures, and a new
key runs uncaptured when its bytes, foreseen per pair from the same spec at
another B, would take the thread's graphs past GRAPH_BYTES_PER_THREAD. So a
thread that meets many batch sizes, as the loop closer does, keeps graphs
for the first ones only. A thread's graphs and buffers are its own: the
mesh's shard threads and the SLAM app's workers never share them. The SLAM
app's loop-closer thread (--lc-thread; one a device for the process,
core/loop_closure.py) captures its graphs under the capture lock while the
tracking thread replays and reads its own, and replays them on the loop
closer's stream. CUDA refuses a device-wide sync while another thread
captures: code that may run beside a capture waits on its stream or an
event, or holds _CAPTURE_LOCK around the sync.
"""

from __future__ import annotations

import threading

import torch

from rgbd360_torch.utils import timing

# Device bytes one aligner's graphs may hold in one thread, as read at their
# captures.
GRAPH_BYTES_PER_THREAD = 8 << 30

# One capture at a time in the process (torch.cuda.graph's rule); replays
# and uncaptured work of other threads go on.
_CAPTURE_LOCK = threading.Lock()


def use_cuda_graphs(device: torch.device) -> bool:
    """The routing predicate: a CUDA device captures, any other does not."""
    return device.type == "cuda"


class Segments:
    """A key's segments: recorded into CUDA graphs on ``stream``, one pool a
    key (its graphs never run at once), or, made without a stream, kept as
    plain calls: the uncaptured route. ``counts``: the aligner's GRAPHS
    group. A segment is a plain function of the loop that owns it, so the
    Segments hold no reference to their loop: an uncaptured loop is freed
    as soon as its caller drops it."""

    def __init__(self, counts, device: torch.device = None, stream=None):
        self.counts, self.device, self.stream = counts, device, stream
        self.captured = stream is not None
        self.nbytes = 0
        self.groups = []
        if self.captured:
            self._reserved = torch.cuda.memory_reserved(device)

    def record(self, owner, groups, buffers) -> None:
        """Keep ``groups``, lists of segment functions of ``owner`` that
        ``replay`` runs in order; captured, run each group once into its
        graph. ``buffers``: the key's inputs, counted in its bytes."""
        if not self.captured:
            self.groups = groups
            return
        pool = torch.cuda.graph_pool_handle()
        with _CAPTURE_LOCK, torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for fns in groups:
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    for fn in fns:
                        fn(owner)
                finally:
                    g.capture_end()
                timing.count(self.counts, "captures")
                self.groups.append(g)
        # the pool's segments, the growth of the reserved memory since the
        # key was made, and the buffers, which may have come from the cache:
        # at least what the key holds (more if another thread allocated
        # meanwhile)
        self.nbytes = (max(torch.cuda.memory_reserved(self.device) - self._reserved, 0)
                       + sum(t.numel() * t.element_size() for t in buffers))

    def replay(self, k: int, owner) -> None:
        """Run group ``k``: replay its graph, or call its functions on
        ``owner``."""
        if self.captured:
            self.groups[k].replay()
        else:
            for fn in self.groups[k]:
                fn(owner)

    def count(self, body: bool) -> None:
        """Count a first sweep, loop body or retry round just run: a replay
        if captured, else an eager body if it was a loop body. A count
        inside a segment would fire once, at the capture."""
        if self.captured:
            timing.count(self.counts, "replays")
        elif body:
            timing.count(self.counts, "eager_bodies")


class GraphCache:
    """One aligner's level loops, per thread: ``loop`` makes or finds the
    loop of a key, captured or not. ``capture(device)`` makes the Segments
    of a key to capture (on the thread's stream of ``device`` by default)."""

    def __init__(self, counts, capture=None):
        self.counts = counts
        self.capture = capture or self._on_stream
        # .loops {key: loop}, .seen {key}, .streams {device: Stream},
        # .held (bytes), .per_pair {spec: the most bytes a key of it took per pair}
        self._local = threading.local()

    def _state(self):
        st = self._local
        if not hasattr(st, "loops"):
            st.loops, st.seen, st.streams, st.held, st.per_pair = {}, set(), {}, 0, {}
        return st

    def _on_stream(self, device: torch.device) -> Segments:
        streams = self._state().streams
        if device not in streams:
            streams[device] = torch.cuda.Stream(device)
        return Segments(self.counts, device, streams[device])

    def loop(self, device: torch.device, bsz: int, spec, make):
        """This thread's loop of (device, B, spec): ``make(segments)`` with
        Segments that capture at the key's second use, within the byte
        bound, and kept; else made anew, uncaptured."""
        if use_cuda_graphs(device):
            st = self._state()
            key = (device, bsz, spec)
            if key not in st.loops and st.held + st.per_pair.get(spec, 0.0) * bsz <= GRAPH_BYTES_PER_THREAD:
                if key not in st.seen:
                    st.seen.add(key)
                else:
                    segments = self.capture(device)
                    st.loops[key] = make(segments)
                    st.held += segments.nbytes
                    st.per_pair[spec] = max(st.per_pair.get(spec, 0.0), segments.nbytes / bsz)
            if key in st.loops:
                return st.loops[key]
        return make(Segments(self.counts))

    def release(self) -> None:
        """Drop this thread's graphs and their buffers; each key's next use
        runs uncaptured again."""
        self._local.__dict__.clear()

    def held_bytes(self) -> int:
        """The device bytes this thread's graphs hold, as read at their
        captures."""
        return getattr(self._local, "held", 0)
