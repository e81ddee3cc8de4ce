"""Kernel: the triple-anchored (FULL) warp gather of full-coverage sweeps,
% of its byte bound at the card's HBM peak."""

from bench360.metrics._roofline import share


def read(ctx):
    return share(ctx, "full")
