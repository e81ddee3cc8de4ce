"""Aligner: host syncs in align_frames360 (photoicp.GN syncs: convergence
reads and uploads that wait for the stream) per Gauss-Newton iteration."""

from bench360.metrics._gn import gn


def read(ctx):
    c = gn()
    if c is None:
        return None
    return c["syncs"] / c["iterations"]
