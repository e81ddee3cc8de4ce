"""Facade: the synced "Dense alignment 360" brackets (the tracking aligns,
and a loop closure's single-pair refinement), ms per frame."""

from bench360.metrics._stages import per_frame


def read(ctx):
    return per_frame(ctx, names=("Dense alignment 360",))
