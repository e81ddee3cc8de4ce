"""Aligner: host time blocked in align_frames360's host syncs
(photoicp.GN wait_ns), per Gauss-Newton iteration (batched loop body), ms."""

from bench360.metrics._gn import gn


def read(ctx):
    c = gn()
    if c is None:
        return None
    return c["wait_ns"] / c["iterations"] / 1e6
