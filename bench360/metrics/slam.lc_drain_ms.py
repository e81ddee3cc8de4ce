"""SLAM back end (thread): the app's stop of the loop closer's thread (every
keyframe still queued searched) and its final drain and graph optimization
(the program's loop_closure.THREAD drain_ns), ms per session, over the
whole sessions the threaded SLAM driver counts (those that ended before
the trace started): each ends with one."""


def read(ctx):
    sessions = ctx.counters.get("lc_sessions")
    if not sessions or "lc_drain_ns" not in ctx.counters:
        return None
    return ctx.counters["lc_drain_ns"] / sessions / 1e6
