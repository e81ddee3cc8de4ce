"""Aligner (robot frame): host time blocked in the level loop's reads
(photoicp_pinhole.GN wait_ns), per batched loop body, ms."""

from bench360.metrics._pinhole_gn import gn


def read(ctx):
    c = gn()
    if c is None:
        return None
    return c["wait_ns"] / c["iterations"] / 1e6
