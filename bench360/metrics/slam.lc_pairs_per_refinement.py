"""SLAM back end: pairs per dense loop-closure refinement (the program's
loop_closure.LC refined_pairs / refinements, over the process: the
warm-up session and the whole window)."""


def read(ctx):
    from rgbd360_torch.core import loop_closure

    counts = getattr(loop_closure, "LC", None)
    if not counts or not counts.get("refinements"):
        return None
    return counts["refined_pairs"] / counts["refinements"]
