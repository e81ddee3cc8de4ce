"""Aligner (robot frame): the level loop's reads of the batch's flags
(photoicp_pinhole.GN syncs: one per loop body, one more per retry round)
per batched loop body."""

from bench360.metrics._pinhole_gn import gn


def read(ctx):
    c = gn()
    if c is None:
        return None
    return c["syncs"] / c["iterations"]
