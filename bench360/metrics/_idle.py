"""Shared by the device readers: the idle share of the traced window, %."""


def idle(ctx):
    tr = ctx.device_trace
    if tr is None or not tr.window_s or tr.busy_s is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
