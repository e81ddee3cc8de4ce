"""Frame360 — the omnidirectional RGB-D frame, device half.

Counterpart of rgbd360_tpu/core/frame360.py, mirroring the reference public
API (include/Frame360.h): loadFrame, undistort, stitchSphericalImage,
buildSphereCloud_fromImage, buildSphereCloud_fast, serialize. The
per-sensor OpenMP fan-out of the reference is a batch axis of size 8. Every
tensor of a frame lies on the frame's ``device``; the raw capture and the
panorama depth stay u16 as the wire format stores them, and the ops compute
in int32 and f32.

The plane layer (get_planes, build_device_fused, build_sphere_cloud,
save_planes, save, load_keyframe) comes with ROADMAP queue 1, slice 3; those
methods raise NotImplementedError naming it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rgbd360_torch.io.boost_archive import RawFrame360, read_frame360_bin, write_frame360_bin
from rgbd360_torch.io.calib import Calib360
from rgbd360_torch.ops.image import gray_f32
from rgbd360_torch.ops.pinhole import backproject_organized
from rgbd360_torch.ops.sphere import sphere_cloud_from_image
from rgbd360_torch.ops.stitch import stitch_maps, stitch_with_maps
from rgbd360_torch.ops.undistort import undistort_depth_mm
from rgbd360_torch.utils.timing import stage

_PLANES = "the plane layer (PbMap, plane extraction) is not ported yet: ROADMAP queue 1, slice 3"


class Frame360:
    """One spherical capture: 8 raw RGB-D images -> panorama -> cloud."""

    def __init__(self, calib: Calib360, frame_id: int = 0, device="cpu"):
        self.calib = calib
        self.id = frame_id
        self.device = torch.device(device)
        self.node = 0
        self.pose = np.eye(4, dtype=np.float32)
        self.timestamp = 0

        self.rgb: Optional[torch.Tensor] = None  # (8,H,W,3) u8 BGR
        self.depth_raw_mm: Optional[torch.Tensor] = None  # (8,H,W) u16
        self._depth_undistorted_m: Optional[torch.Tensor] = None  # (8,H,W) f32
        self.sphere_rgb: Optional[torch.Tensor] = None  # (320,1920,3) u8 BGR
        self.sphere_depth_mm: Optional[torch.Tensor] = None  # (320,1920) u16
        self.sphere_gray: Optional[torch.Tensor] = None  # (320,1920) f32 [0,1]
        self.sphere_cloud = None  # (xyz, rgb) from buildSphereCloud_fromImage
        self.planes = None
        self.local_planes = None

    def _sync(self) -> None:
        """Completion of the frame's device work, for the timing brackets
        (called only when timing is on)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- acquisition / io ---------------------------------------------------
    def load_frame(self, path: str) -> None:
        """Load the 8-sensor raw capture (reference include/Frame360.h:231-266)."""
        with stage("Frame360.loadFrame", sync=self._sync):
            self.set_raw(read_frame360_bin(path))

    def set_raw(self, raw: RawFrame360) -> None:
        self.rgb = torch.from_numpy(np.ascontiguousarray(raw.rgb)).to(self.device)
        self.depth_raw_mm = torch.from_numpy(np.ascontiguousarray(raw.depth)).to(self.device)
        self._depth_undistorted_m = None  # lazy (see depth_undistorted_m)
        self.timestamp = raw.timestamp

    @property
    def depth_undistorted_m(self) -> Optional[torch.Tensor]:
        """Metric per-sensor depth: the CLAMS-undistorted field once
        undistort() has run, else the plain loadDepthEigen u16-mm -> f32-m
        conversion (CloudRGBD_Ext.h:64-76), made on first read."""
        if self._depth_undistorted_m is None and self.depth_raw_mm is not None:
            self._depth_undistorted_m = self.depth_raw_mm.to(torch.float32) * 0.001
        return self._depth_undistorted_m

    @depth_undistorted_m.setter
    def depth_undistorted_m(self, value) -> None:
        self._depth_undistorted_m = value

    def serialize(self, path: str) -> None:
        """Write the reference-compatible .bin (include/Frame360.h:333-345)."""
        write_frame360_bin(
            path,
            RawFrame360(
                rgb=self.rgb.cpu().numpy(),
                depth=self.depth_raw_mm.cpu().numpy(),
                timestamp=self.timestamp,
            ),
        )

    # -- device pipeline ----------------------------------------------------
    def undistort(self) -> None:
        """CLAMS depth undistortion of all 8 sensors in one batched pass
        (reference include/Frame360.h:293-310). Like the reference, this
        updates only the metric depth used for point clouds — the raw u16
        depth the stitcher reads stays distorted (the eigen2cv write-back
        at Frame360.h:302 is commented out)."""
        with stage("Frame360.undistort", sync=self._sync):
            mults, counts, geom = self.calib.device_intrinsic_arrays(self.device)
            self.depth_undistorted_m = undistort_depth_mm(
                self.depth_raw_mm, mults, counts,
                bin_width=geom.bin_width, bin_height=geom.bin_height, bin_depth=geom.bin_depth,
            )

    def stitch_spherical_image(self) -> None:
        """Build the 1920x320 spherical RGB-D panorama
        (reference include/Frame360.h:386-405). The sampling maps are made
        once per calibration, sensor size and device."""
        with stage("Frame360.stitchSphericalImage", sync=self._sync):
            _s, size_h, size_w = self.depth_raw_mm.shape

            def make():
                _rt, rt_inv, cam = self.calib.device_extrinsic_arrays(self.device)
                return stitch_maps(rt_inv, cam, size_h, size_w)

            maps = self.calib.cached(("stitch_maps", str(self.device), size_h, size_w), make)
            self.sphere_rgb, self.sphere_depth_mm = stitch_with_maps(self.rgb, self.depth_raw_mm, maps)
            self.sphere_gray = gray_f32(self.sphere_rgb)

    def build_sphere_cloud_from_image(self):
        """Spherical point cloud from the stitched panorama
        (reference include/Frame360.h:555-612)."""
        assert self.sphere_rgb is not None, "stitch_spherical_image() first"
        depth_m = self.sphere_depth_mm.to(torch.float32) * 0.001
        self.sphere_cloud = sphere_cloud_from_image(self.sphere_rgb, depth_m)
        return self.sphere_cloud

    def build_sphere_cloud_fast(self):
        """buildSphereCloud_fast (reference include/Frame360.h:522-552):
        per-sensor undistorted backprojection transformed by the extrinsics
        and concatenated — no downsampling, no bilateral filter. Returns
        numpy (xyz (8*H*W, 3), rgb (8*H*W, 3) RGB), as the JAX method."""
        xyz = backproject_organized(self.depth_undistorted_m)  # (8,H,W,3)
        rt, _rt_inv, _cam = self.calib.device_extrinsic_arrays(self.device)
        pts = torch.einsum("sij,shwj->shwi", rt[:, :3, :3], xyz) + rt[:, None, None, :3, 3]
        rgb = self.rgb.cpu().numpy()[..., ::-1]  # BGR -> RGB
        self.sphere_cloud = (pts.cpu().numpy().reshape(-1, 3), rgb.reshape(-1, 3))
        return self.sphere_cloud

    # -- the plane layer (ROADMAP queue 1, slice 3) -------------------------
    def get_planes(self, need_inliers: bool = True):
        raise NotImplementedError(f"Frame360.get_planes: {_PLANES}")

    def build_device_fused(self, ship_labels: bool = False):
        raise NotImplementedError(f"Frame360.build_device_fused: {_PLANES}")

    def build_sphere_cloud(self):
        raise NotImplementedError(f"Frame360.build_sphere_cloud: {_PLANES}")

    def save_planes(self, path: str) -> None:
        raise NotImplementedError(f"Frame360.save_planes: {_PLANES}")

    def save(self, path: str, frame: int) -> None:
        raise NotImplementedError(f"Frame360.save: {_PLANES}")

    @classmethod
    def load_keyframe(cls, calib: Calib360, path: str, frame: int) -> "Frame360":
        raise NotImplementedError(f"Frame360.load_keyframe: {_PLANES}")

    # -- convenience --------------------------------------------------------
    def build(self, path: str) -> "Frame360":
        """load + undistort + stitch: the standard per-frame pipeline."""
        self.load_frame(path)
        self.undistort()
        self.stitch_spherical_image()
        return self
