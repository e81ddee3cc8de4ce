"""Shared by the stage readers: a sum of the program's stage brackets
(rgbd360_torch/utils/timing.py) over the untraced rest of the traced
window, per frame finished there. Where none of the named brackets
appeared (a stage renamed, or never reached), there is nothing to read:
None, never 0."""


def per_frame(ctx, names=(), prefix=None, leave_out=()):
    if not ctx.units or not ctx.stages:
        return None
    seen = [ms for name, ms in ctx.stages.items()
            if (name in names or (prefix is not None and name.startswith(prefix))) and name not in leave_out]
    return sum(seen) / ctx.units if seen else None
