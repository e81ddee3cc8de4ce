"""SLAM back end (thread): keyframes waiting behind the one the loop
closer's thread takes, on average over its takes (the program's
loop_closure.THREAD queued_at_take / taken, over the whole sessions the
threaded SLAM driver counts: those that ended before the trace started).
0 where the thread keeps up."""


def read(ctx):
    taken = ctx.counters.get("lc_taken")
    if not taken:
        return None
    return ctx.counters["lc_queued_at_take"] / taken
