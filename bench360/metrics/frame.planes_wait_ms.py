"""Planes: the "planes join (thread)" brackets alone, the caller's wait for
the planes worker (the one part of the plane layer on a frame's critical
path in the threaded pipeline), ms per frame."""

from bench360.metrics._stages import per_frame


def read(ctx):
    return per_frame(ctx, names=("planes join (thread)",))
