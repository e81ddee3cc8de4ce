"""Count the aten operations one Gauss-Newton / Levenberg-Marquardt
iteration of the port's aligners dispatches, by part: the sweep, the
well-posedness Cholesky, the 6x6 solve with the SE(3) update; and those of
the stereo plane program (core/frame360_stereo.py) by stage, with the
segmentation's and the refinement's sweeps (one host sync each). Each
non-view aten operation is about one kernel launch on the card, and the
eager aligners are bound by issuing them, so the count prices an
iteration's host cost without a card. Runs on the CPU (no GPU needed):

    python tools/count_iteration_ops.py

The pinhole case is the 8-camera robot-frame sweep at its L0 (8 x 240 x
320, PHOTO_DEPTH, tools/synthetic_rig.py's room), the sphere case the
exact-gather sweep of one 1920 x 320 pair (seeded random images: the
count does not depend on the data). The stereo program runs on the room
ray-cast as a 1024 x 180 stereo panorama (tools/synthetic_rig.py): its
sweeps run to a fixed point, so its count depends on the data.
"""

from __future__ import annotations

import collections
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rgbd360_torch.core.calibrator import construction_specs  # noqa: E402
from rgbd360_torch.io.calib import qvga_camera_matrix  # noqa: E402
from rgbd360_torch.ops import linalg6, photoicp, se3  # noqa: E402
from rgbd360_torch.ops import photoicp_pinhole as pp  # noqa: E402
from rgbd360_torch.ops.image import gray_f32  # noqa: E402
from rgbd360_torch.ops.sphere import sphere_xyz_lut  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402

# metadata-only operations: no kernel
VIEWS = {"view", "_unsafe_view", "reshape", "expand", "slice", "select", "unsqueeze", "squeeze", "transpose", "t",
         "permute", "alias", "detach", "as_strided", "lift_fresh"}


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in VIEWS:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    with CountOps() as c:
        fn()
    return sum(c.counts.values())


def step_ops(H, g, pseudo: bool) -> dict:
    eye6 = torch.eye(6)
    ok = linalg6.spd_well_posed(H, 1e-3)
    solve = lambda: se3.exp_se3(-linalg6.solve6_sym(H + 1e-3 * (eye6 * H) + (~ok).float() * eye6, g)[0], pseudo)
    return {"well-posed Cholesky": count(lambda: linalg6.spd_well_posed(H, 1e-3)), "solve + SE(3) update": count(solve)}


def stereo_program() -> dict:
    """{stage: (aten ops, host-synced sweeps)} of the stereo plane program."""
    from rgbd360_torch.core import frame360_stereo as st
    from rgbd360_torch.ops import normals, plane_stats, planes_seg

    rgb, depth = rig.raycast_room_stereo(rig.stereo_pose())
    xyz = st.stereo_cloud(torch.from_numpy(np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)).float() * 1e-3)[None]
    parts = {}

    def stage(name, fn):
        with CountOps() as c:
            out = fn()
        # the flood fill's and the refinement's sweeps each end on one any()
        parts[name] = (sum(c.counts.values()), c.counts["any"] if name in ("segment", "refine") else 0)
        return out

    n = stage("normals", lambda: normals.organized_normals(xyz, max_depth_change=0.05))
    pre = stage("segment", lambda: planes_seg.segment_planes(xyz, n, angular_threshold=0.05, distance_threshold=0.05))
    lab = stage("refine", lambda: planes_seg.refine_plane_labels(pre, xyz, n, distance_threshold=0.05,
                                                                min_inliers=st.MIN_INLIERS_STEREO))
    stage("stats", lambda: plane_stats.sensor_plane_stats(xyz, torch.from_numpy(rgb)[None], lab, pre))
    return parts


def main() -> int:
    torch.set_num_threads(2)
    rts = construction_specs().astype(np.float32)
    src, trg = rig.room_capture(rig.loop_pose(0.1, 0.8), rts), rig.room_capture(rig.loop_pose(0.0, 0.8), rts)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    level = photoicp.make_level_data(
        photoicp.build_pyramid_set(gray_f32(t(src.rgb)), t(src.depth).float() * 0.001, 1, is_target=False,
                                   sphere_seam_mask=False),
        photoicp.build_pyramid_set(gray_f32(t(trg.rgb)), t(trg.depth).float() * 0.001, 1, is_target=True,
                                   sphere_seam_mask=False), 0)
    k = t(qvga_camera_matrix())
    xyz, valid = pp.pinhole_lut(level.depth_src, k, 0)
    planes = photoicp.pack_target_planes8(level)
    sweep = lambda: pp.fused_sweep_pinhole(level.gray_src.reshape(8, -1), planes, (240, 320), xyz, valid,
                                           torch.eye(4), k, 0, pp.PHOTO_DEPTH, t(rts))
    out = sweep()
    pinhole = {"sweep": count(sweep), **step_ops(out[2], out[3], pseudo=False)}

    gen = torch.Generator().manual_seed(0)  # the count does not depend on the data
    gray, depth = torch.rand((1, 320, 1920), generator=gen), 1.0 + torch.rand((1, 320, 1920), generator=gen)
    s = photoicp.build_pyramid_set(gray, depth, 1, is_target=False, sphere_seam_mask=True)
    lv = photoicp.make_level_data(s, photoicp.build_pyramid_set(gray, depth, 1, is_target=True, sphere_seam_mask=True), 0)
    xyz_s, valid_s = sphere_xyz_lut(lv.depth_src, photoicp.MIN_DEPTH, photoicp.MAX_DEPTH)
    sweep_s = lambda: photoicp.fused_sweep_sphere(lv.gray_src.reshape(1, -1), photoicp.pack_target_planes8(lv),
                                                  (320, 1920), xyz_s, valid_s, torch.eye(4)[None], photoicp.PHOTO_DEPTH)
    out_s = sweep_s()
    sphere = {"sweep": count(sweep_s), **step_ops(out_s[1][0], out_s[2][0], pseudo=True)}
    for name, parts in (("pinhole robot-frame iteration (8 x 240 x 320)", pinhole),
                        ("sphere iteration (1 x 320 x 1920, exact gather)", sphere)):
        print(f"{name}: {sum(parts.values())} aten ops: " + ", ".join(f"{k} {v}" for k, v in parts.items()))
    stereo = stereo_program()
    print(f"stereo plane program (1 x 180 x 1024, the room): {sum(n for n, _s in stereo.values())} aten ops: "
          + ", ".join(f"{k} {n}" + (f" ({s} sweeps)" if s else "") for k, (n, s) in stereo.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
