"""Aligner: the share of Gauss-Newton loop bodies replayed from CUDA
graphs in the SLAM cells (tracking and loop-closure aligns), %."""

from bench360.metrics._graphs import graph_share


def read(ctx):
    return graph_share()
