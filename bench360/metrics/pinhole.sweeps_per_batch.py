"""Aligner (robot frame): batched sweeps (photoicp_pinhole.SWEEPS "sweeps",
the Levenberg-Marquardt retry sweeps among them) over the untraced rest of
the window, per batch sent there."""


def read(ctx):
    c = ctx.counters
    if not c.get("rig_batches"):
        return None
    return c["rig_sweeps"] / c["rig_batches"]
