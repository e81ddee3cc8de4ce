"""Shared by the aligner's host readers: the program's photoicp.GN counter
group (the Gauss-Newton loop's host side, counted since the pair driver's
reset at the window's start, the profiled tail included). None where the
program has no such group or ran no iteration."""


def gn():
    from rgbd360_torch.ops import photoicp

    counts = getattr(photoicp, "GN", None)
    if not counts or not counts.get("iterations"):
        return None
    return counts
