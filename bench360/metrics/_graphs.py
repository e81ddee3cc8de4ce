"""Shared by the CUDA-graph readers: the share (%) of the aligner's
Gauss-Newton loop bodies replayed from CUDA graphs, the program's
photoicp.GN iterations less photoicp.GRAPHS eager_bodies, over the
iterations. Both groups count from the same reset: the pair driver's at
the window's start; in the SLAM cells, whose driver resets nothing, the
whole process, warm-up included. None where the program has no GRAPHS
group or ran no iteration."""

from bench360.metrics._gn import gn


def graph_share():
    from rgbd360_torch.ops import photoicp

    counts, graphs = gn(), getattr(photoicp, "GRAPHS", None)
    if counts is None or graphs is None:
        return None
    return 100.0 * (counts["iterations"] - graphs["eager_bodies"]) / counts["iterations"]
