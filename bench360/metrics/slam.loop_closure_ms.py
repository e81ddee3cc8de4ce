"""SLAM back end: the "Loop closure" and "Graph optimization" brackets, ms per frame."""

from bench360.metrics._stages import per_frame


def read(ctx):
    return per_frame(ctx, names=("Loop closure", "Graph optimization"))
