"""Aligner: the untraced rest of the window's align_batch wall time (each
call up to its read-back) over the Gauss-Newton iterations the batched
loop ran (per level, the most any pair of the batch accepted), ms."""


def read(ctx):
    c = ctx.counters
    if not c.get("gn_iterations"):
        return None
    return c["align_s"] * 1000.0 / c["gn_iterations"]
