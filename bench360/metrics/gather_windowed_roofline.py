"""Kernel: the single-anchor windowed warp gather (csrc/warp_gather.cu),
% of its byte bound at the card's HBM peak."""

from bench360.metrics._roofline import share


def read(ctx):
    return share(ctx, "windowed")
