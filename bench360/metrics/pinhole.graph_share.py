"""Aligner (robot frame): the share of the level loop's bodies replayed
from CUDA graphs, %: the program's photoicp_pinhole.GN iterations less
photoicp_pinhole.GRAPHS eager_bodies, over the iterations, both counted
from the rig driver's reset at the window's start. None where the program
has no GRAPHS group or ran no iteration."""

from bench360.metrics._pinhole_gn import gn


def read(ctx):
    from rgbd360_torch.ops import photoicp_pinhole

    counts, graphs = gn(), getattr(photoicp_pinhole, "GRAPHS", None)
    if counts is None or graphs is None:
        return None
    return 100.0 * (counts["iterations"] - graphs["eager_bodies"]) / counts["iterations"]
