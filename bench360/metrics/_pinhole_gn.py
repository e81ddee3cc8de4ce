"""Shared by the robot-frame aligner's host readers: the program's
photoicp_pinhole.GN counter group (the batched level loop's host side,
counted since the rig driver's reset at the window's start, the profiled
tail included). None where the program has no such group or ran no
iteration."""


def gn():
    from rgbd360_torch.ops import photoicp_pinhole

    counts = getattr(photoicp_pinhole, "GN", None)
    if not counts or not counts.get("iterations"):
        return None
    return counts
