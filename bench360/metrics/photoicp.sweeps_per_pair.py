"""Aligner: batched sweeps (photoicp.SWEEPS, every branch) over the
untraced rest of the window, per pair registered there."""


def read(ctx):
    if not ctx.units or "sweeps" not in ctx.counters:
        return None
    return ctx.counters["sweeps"] / ctx.units
