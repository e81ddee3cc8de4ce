"""Shared by the kernel readers: the warp gather's share of its byte bound
(lib/roofline.py) over the launches of one form in the traced window,
each launch's device time from the profiler, in launch order."""

from bench360.lib.roofline import bound_seconds


def share(ctx, kind):
    tr = ctx.device_trace
    if tr is None or not tr.kernels or len(tr.kernels) != len(tr.launches):
        return None
    bound = measured = 0.0
    for (k, nbytes), (_start, dur_us) in zip(tr.launches, tr.kernels):
        if k == kind:
            b = bound_seconds(nbytes, ctx.device_kind)
            if b is None:
                return None
            bound += b
            measured += dur_us / 1e6
    return 100.0 * bound / measured if measured > 0 else None
