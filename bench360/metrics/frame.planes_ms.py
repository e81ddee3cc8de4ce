"""Planes: the "planes *" brackets but "planes dispatch", which holds the
frame's Frame360.build_device_fused bracket (frame.build_ms), ms per
frame; the worker thread's collect and host fit count as thread time."""

from bench360.metrics._stages import per_frame


def read(ctx):
    return per_frame(ctx, prefix="planes ", leave_out=("planes dispatch",))
