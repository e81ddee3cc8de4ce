"""Aligner: host time inside align_frames360 spent other than blocked on
the device (photoicp.GN host_ns - wait_ns), per Gauss-Newton iteration
(batched loop body), ms."""

from bench360.metrics._gn import gn


def read(ctx):
    c = gn()
    if c is None:
        return None
    return (c["host_ns"] - c["wait_ns"]) / c["iterations"] / 1e6
