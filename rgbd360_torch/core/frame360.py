"""Frame360 — the omnidirectional RGB-D frame.

Counterpart of rgbd360_tpu/core/frame360.py, mirroring the reference public
API (include/Frame360.h): loadFrame, undistort, stitchSphericalImage,
buildSphereCloud_fromImage, buildSphereCloud(_fast), getPlanes, serialize,
save / load_PbMap_Cloud. The per-sensor OpenMP fan-out of the reference is
a batch axis of size 8. Every tensor of a frame lies on the frame's
``device`` — the card unless the caller names another (device.py); the raw
capture and the panorama depth stay u16 as the wire format stores them, and
the ops compute in int32 and f32. Planes (PbMap) and saved keyframes are
host numpy, as in JAX.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from rgbd360_torch.device import resolve_device
from rgbd360_torch.io.boost_archive import RawFrame360, read_frame360_bin, write_frame360_bin
from rgbd360_torch.io.calib import Calib360
from rgbd360_torch.ops.image import gray_f32
from rgbd360_torch.ops.pinhole import backproject_organized
from rgbd360_torch.ops.sphere import sphere_cloud_from_image
from rgbd360_torch.ops.stitch import stitch_maps, stitch_with_maps
from rgbd360_torch.ops.undistort import undistort_depth_mm
from rgbd360_torch.utils.timing import stage


class Frame360:
    """One spherical capture: 8 raw RGB-D images -> panorama -> cloud/planes."""

    def __init__(self, calib: Calib360, frame_id: int = 0, device=None):
        self.calib = calib
        self.id = frame_id
        self.device = resolve_device(device)
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
        self.planes = None  # PbMap (set by get_planes)
        self.local_planes = None

    def _sync(self) -> None:
        """Completion of the frame's device work, for the timing brackets
        (called only when timing is on): the calling thread's stream, not
        the whole device, which CUDA refuses while another thread (the loop
        closer's, say) captures a CUDA graph."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

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

    def _stitch_maps(self):
        """The stitch sampling maps of this calibration, sensor size and
        device, made once (ops/stitch.py::stitch_maps)."""
        _s, size_h, size_w = self.depth_raw_mm.shape

        def make():
            _rt, rt_inv, cam = self.calib.device_extrinsic_arrays(self.device)
            return stitch_maps(rt_inv, cam, size_h, size_w)

        return self.calib.cached(("stitch_maps", str(self.device), size_h, size_w), make)

    def stitch_spherical_image(self) -> None:
        """Build the 1920x320 spherical RGB-D panorama
        (reference include/Frame360.h:386-405)."""
        with stage("Frame360.stitchSphericalImage", sync=self._sync):
            self.sphere_rgb, self.sphere_depth_mm = stitch_with_maps(self.rgb, self.depth_raw_mm, self._stitch_maps())
            self.sphere_gray = gray_f32(self.sphere_rgb)

    def build_device_fused(self, ship_labels: bool = False) -> torch.Tensor:
        """The whole per-frame device pipeline (CLAMS undistort + spherical
        stitch + gray + plane stats) in one call; returns the device plane-
        stats buffer and sets sphere_rgb/sphere_depth_mm/sphere_gray/
        depth_undistorted_m from the outputs (frame360.py:126).
        planes_pipeline uses it on deferred-build frames."""
        from rgbd360_torch.core.plane_extraction import fused_frame_program

        with stage("Frame360.build_device_fused", sync=self._sync):
            mults, counts, geom = self.calib.device_intrinsic_arrays(self.device)
            (self.sphere_rgb, self.sphere_depth_mm, self.sphere_gray, self._depth_undistorted_m, stats) = fused_frame_program(
                self.rgb, self.depth_raw_mm, mults, counts, self._stitch_maps(), ship_labels=ship_labels,
                bin_width=geom.bin_width, bin_height=geom.bin_height, bin_depth=geom.bin_depth,
            )
        return stats

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

    def build_sphere_cloud(self):
        """Rig-frame point cloud from the 8 undistorted, downsampled,
        bilateral-filtered sensor clouds (reference include/Frame360.h:467-519
        buildSphereCloud): returns numpy (xyz (8*h*w, 3), rgb) with the
        per-sensor blocks transformed by their extrinsics, as the JAX method."""
        from rgbd360_torch.core.plane_extraction import build_sensor_clouds

        xyz, rgb2, _, _ = build_sensor_clouds(self.depth_undistorted_m, self.rgb)
        xyz = xyz.cpu().numpy()  # (8, h, w, 3) sensor frames
        rgb2 = rgb2.cpu().numpy()
        out = np.empty((8, xyz.shape[1] * xyz.shape[2], 3), np.float32)
        for s in range(8):
            rt = self.calib.Rt[s].astype(np.float64)
            out[s] = (xyz[s].reshape(-1, 3) @ rt[:3, :3].T + rt[:3, 3]).astype(np.float32)
        self.sphere_cloud = (out.reshape(-1, 3), rgb2[..., ::-1].reshape(-1, 3))
        return self.sphere_cloud

    # -- the plane layer ------------------------------------------------------
    def get_planes(self, need_inliers: bool = True):
        """Segment + merge the planar patches of the spherical frame
        (reference include/Frame360.h:615-638): the device program on the
        frame's device, one host copy, the host fit. need_inliers=False
        skips the per-pixel labels (Plane.inliers stays None) — the
        odometry/SLAM-loop configuration."""
        from rgbd360_torch.core.plane_extraction import extract_frame_planes

        with stage("Frame360.getPlanes (segmentation)"):
            self.planes, self.local_planes = extract_frame_planes(self, need_inliers=need_inliers)
        return self.planes

    def get_planar_area(self) -> float:
        if self.planes is None:
            return 0.0
        return float(sum(p.area_hull for p in self.planes.planes))

    # -- keyframe persistence (reference Frame360.h:213-228, 313-330) --------
    def save_planes(self, path: str) -> None:
        """savePlanes: persist the PbMap (reference Frame360.h:321-327); the
        .pbmap.npz format of the JAX package."""
        from rgbd360_torch.core.pbmap import save_pbmap

        if self.planes is None:
            raise RuntimeError("get_planes() first")
        save_pbmap(self.planes, path)

    def save(self, path: str, frame: int) -> None:
        """Save the keyframe as sphereCloud_%d.pcd + spherePlanes_%d.pbmap.npz
        (reference Frame360::save, Frame360.h:313-330), plus the stitched
        panorama (panorama_%d.npz, an extension of the JAX package: without
        it a reloaded keyframe cannot serve dense re-registration). The same
        files as the JAX method."""
        from rgbd360_torch.utils.viz import save_pcd

        # the keyframe cloud is ALWAYS the panorama backprojection, never a
        # cached rig-frame cloud of another shape and frame
        depth_m = self.sphere_depth_mm.to(torch.float32) * 0.001
        xyz, rgb = sphere_cloud_from_image(self.sphere_rgb, depth_m)
        h, w = self.sphere_depth_mm.shape
        # NaNs kept: they mark invalid pixels of the organized cloud
        save_pcd(os.path.join(path, f"sphereCloud_{frame}.pcd"), xyz.cpu().numpy().reshape(-1, 3),
                 rgb.cpu().numpy().reshape(-1, 3), organized_shape=(h, w))
        self.save_planes(os.path.join(path, f"spherePlanes_{frame}.pbmap.npz"))
        np.savez_compressed(
            os.path.join(path, f"panorama_{frame}.npz"),
            sphere_rgb=self.sphere_rgb.cpu().numpy(),
            sphere_depth_mm=self.sphere_depth_mm.cpu().numpy(),
            pose=self.pose,
            node=self.node,
            timestamp=self.timestamp,
        )

    @classmethod
    def load_keyframe(cls, calib: Calib360, path: str, frame: int, device=None) -> "Frame360":
        """Reload a saved keyframe (reference load_PbMap_Cloud,
        Frame360.h:213-228, with the panorama so the keyframe can re-enter
        tracking after a restart); the panorama goes to ``device``."""
        from rgbd360_torch.core.pbmap import load_pbmap
        from rgbd360_torch.utils.viz import load_pcd

        kf = cls(calib, frame, device)
        kf.sphere_cloud = load_pcd(os.path.join(path, f"sphereCloud_{frame}.pcd"))
        kf.planes = load_pbmap(os.path.join(path, f"spherePlanes_{frame}.pbmap.npz"))
        pano_path = os.path.join(path, f"panorama_{frame}.npz")
        if os.path.exists(pano_path):
            with np.load(pano_path) as z:
                kf.sphere_rgb = torch.from_numpy(z["sphere_rgb"]).to(kf.device)
                kf.sphere_depth_mm = torch.from_numpy(z["sphere_depth_mm"]).to(kf.device)
                kf.pose = z["pose"]
                kf.node = int(z["node"])
                kf.timestamp = int(z["timestamp"])
            kf.sphere_gray = gray_f32(kf.sphere_rgb)
        return kf

    # -- convenience --------------------------------------------------------
    def build(self, path: str) -> "Frame360":
        """load + undistort + stitch: the standard per-frame pipeline."""
        self.load_frame(path)
        self.undistort()
        self.stitch_spherical_image()
        return self
