"""SLAM back end: the loop closer's "LC dense refinement" spans (phase 2,
batched or single, up to its read-back), ms per frame."""

from bench360.metrics._stages import per_frame


def read(ctx):
    return per_frame(ctx, names=("LC dense refinement",))
