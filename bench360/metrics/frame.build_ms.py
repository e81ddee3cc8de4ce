"""Frames: the synced Frame360.* brackets (load, and undistort + stitch +
plane statistics in one device program), ms per frame."""

from bench360.metrics._stages import per_frame


def read(ctx):
    return per_frame(ctx, prefix="Frame360.")
