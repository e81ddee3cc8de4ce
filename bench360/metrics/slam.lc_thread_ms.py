"""SLAM back end (thread): the loop closer's thread's "loop closure
(thread)" spans, one per keyframe it took, ms per frame finished in the
untraced part of the window. Thread time, beside the frame's critical
path."""

from bench360.metrics._stages import per_frame


def read(ctx):
    return per_frame(ctx, names=("loop closure (thread)",))
