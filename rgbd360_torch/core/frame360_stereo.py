"""Frame360Stereo — spherical frames from a stereo panorama device
(reference include/Frame360_stereo.h): the RGB panorama arrives as a PNG and
the float depth panorama as a raw binary (u16 height, u16 width header then
height*width f32 values stored transposed, :268-315).

Counterpart of rgbd360_tpu/core/frame360_stereo.py. ``read_stereo_depth``
and ``write_stereo_depth`` are copies; the device program of
getPlanesStereo (``stereo_plane_stats``, XLA code in JAX) is plain torch
ops on the frame's device: the plane layer's normals, segmentation,
refinement and per-label statistics (ops/normals.py, ops/planes_seg.py,
ops/plane_stats.py) with one sensor (S = 1) and the stereo variant's
thresholds. The panorama depth stays u16 millimetres as in Frame360 and is
cast to f32 before any arithmetic.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from rgbd360_torch.config import default_params
from rgbd360_torch.core.frame360 import Frame360
from rgbd360_torch.io.calib import Calib360
from rgbd360_torch.ops.image import gray_f32

# stereo PCL segmentation configuration (Frame360_stereo.h:859-867)
_ANGULAR, _DIST, _MAX_DEPTH_CHANGE = 0.05, 0.05, 0.05
MIN_INLIERS_STEREO = 40  # :865


def _stereo_rays(h: int, w: int, start_phi: float):
    """The f32 trigonometry of the stereo backprojection (Frame360_stereo.h:
    454-517), on the host in numpy as the JAX package's build_sphere_cloud
    computes it: (sin_th (1,w), cos_phi (h,1), sin_phi (h,1), cos_th (1,w))."""
    step = 2.0 * np.pi / w
    phi = (np.arange(h, dtype=np.float32) + np.float32(start_phi)) * step - np.pi / 2
    theta = np.arange(w, dtype=np.float32) * step - np.pi
    return np.sin(theta)[None, :], np.cos(phi)[:, None], np.sin(phi)[:, None], np.cos(theta)[None, :]


def stereo_cloud(depth_m: torch.Tensor, start_phi: float = 166, max_depth: float = 15.0) -> torch.Tensor:
    """(h, w) f32 metres -> the organized cloud (h, w, 3) on depth_m's
    device: x = sin(theta) cos(phi) d, y = sin(phi) d, z = cos(theta)
    cos(phi) d, valid depth in (0, max_depth), NaN elsewhere."""
    h, w = depth_m.shape
    sin_th, cos_phi, sin_phi, cos_th = (torch.from_numpy(a).to(depth_m.device) for a in _stereo_rays(h, w, start_phi))
    valid = (depth_m > 0.0) & (depth_m < max_depth)
    d = torch.where(valid, depth_m, torch.full((), float("nan"), device=depth_m.device))
    x = (sin_th * cos_phi) * d
    y = sin_phi * d
    z = (cos_th * cos_phi) * d
    return torch.stack([x, y, z], dim=-1)


def stereo_segments(depth_m: torch.Tensor, start_phi: float = 166, max_depth: float = 15.0):
    """The head of getPlanesStereo's device program: the organized cloud,
    its normals, the segmentation and the refinement with the stereo
    variant's thresholds, one sensor (S = 1). Returns (xyz (1, h, w, 3),
    segment-stage labels (1, h, w), refined labels (1, h, w))."""
    from rgbd360_torch.ops.normals import organized_normals
    from rgbd360_torch.ops.planes_seg import refine_plane_labels, segment_planes

    xyz = stereo_cloud(depth_m, start_phi, max_depth)[None]
    normals = organized_normals(xyz, max_depth_change=_MAX_DEPTH_CHANGE)
    labels_pre = segment_planes(xyz, normals, angular_threshold=_ANGULAR, distance_threshold=_DIST)
    # min_inliers=40: the stereo variant's acceptance threshold (:865) also
    # gates which regions may grow in the refinement
    labels = refine_plane_labels(labels_pre, xyz, normals, distance_threshold=_DIST, min_inliers=MIN_INLIERS_STEREO)
    return xyz, labels_pre, labels


def stereo_plane_stats(depth_m: torch.Tensor, rgb_bgr: torch.Tensor, start_phi: float = 166, max_depth: float = 15.0):
    """The device program of getPlanesStereo (frame360_stereo.py:24):
    backproject the organized stereo panorama, segment planes, reduce
    per-label stats; everything on depth_m's device. Returns
    (SensorPlaneStats with S = 1, xyz (h, w, 3))."""
    from rgbd360_torch.ops.plane_stats import sensor_plane_stats

    xyz, labels_pre, labels = stereo_segments(depth_m, start_phi, max_depth)
    return sensor_plane_stats(xyz, rgb_bgr[None], labels, labels_pre), xyz[0]


def read_stereo_depth(path: str) -> np.ndarray:
    """Raw stereo depth panorama: [u16 h][u16 w][h*w f32 column-major]
    (reference Frame360_stereo.h:268-305) -> (h, w) f32 metres."""
    with open(path, "rb") as f:
        buf = f.read()
    h, w = struct.unpack("<HH", buf[:4])
    data = np.frombuffer(buf[4 : 4 + h * w * 4], np.float32)
    # stored as (w, h) then transposed by the reference
    return data.reshape(w, h).T.copy()


def write_stereo_depth(path: str, depth_m: np.ndarray) -> None:
    h, w = depth_m.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<HH", h, w))
        f.write(np.ascontiguousarray(depth_m.T, np.float32).tobytes())


class Frame360Stereo(Frame360):
    """Frame360 whose panorama comes directly from files instead of the
    8-sensor stitcher; its tensors lie on the frame's ``device`` (the card
    unless the caller names another)."""

    def __init__(self, calib: Calib360 = None, frame_id: int = 0, device=None):
        super().__init__(calib or Calib360(), frame_id, device)

    def load_depth(self, path: str) -> None:
        depth_m = read_stereo_depth(path)
        self.sphere_depth_mm = torch.from_numpy(np.clip(depth_m * 1000.0, 0, 65535).astype(np.uint16)).to(self.device)

    def load_rgb(self, path: str) -> None:
        from rgbd360_torch.utils.viz import load_png

        rgb = load_png(path)
        self.sphere_rgb = torch.from_numpy(np.ascontiguousarray(rgb[..., ::-1])).to(self.device)  # keep BGR
        self.sphere_gray = gray_f32(self.sphere_rgb)

    def build_stereo(self, rgb_png: str, depth_bin: str) -> "Frame360Stereo":
        self.load_rgb(rgb_png)
        self.load_depth(depth_bin)
        return self

    def depth_m(self) -> torch.Tensor:
        """The panorama depth in f32 metres on the frame's device, as the
        JAX methods convert it (frame360_stereo.py:126)."""
        return self.sphere_depth_mm.to(torch.float32) * 1e-3

    def get_planes_stereo(self, start_phi: int = 166, max_depth: float = 15.0):
        """Plane segmentation over the stereo panorama cloud (reference
        Frame360_stereo.h:847-986 getPlanesStereo): the variant's own PCL
        configuration — maxDepthChange 0.05, smoothing 8, minInliers 40,
        angular threshold 0.05 rad, distance threshold 0.05 m (:859-867) —
        over the ORGANIZED stereo cloud, no per-sensor split, no rig
        transform; same area/elongation filters and local same-plane merge
        as Frame360 (:938-978). The device program on the frame's device,
        then the host fit of frame360_stereo.py:111 (copied). Sets and
        returns self.planes."""
        from rgbd360_torch.core.pbmap import PbMap, Plane
        from rgbd360_torch.core.plane_extraction import local_same_plane_merge

        st, xyz = stereo_plane_stats(self.depth_m(), self.sphere_rgb, start_phi, max_depth)
        st = type(st)(*(t[0].cpu().numpy() for t in st))
        xyzf = xyz.cpu().numpy().reshape(-1, 3)
        count = st.count
        mean = st.mean.astype(np.float64)
        cov = st.cov.astype(np.float64)
        normal = st.normal.astype(np.float64)
        curvature = st.curvature.astype(np.float64)
        hist = st.hist.astype(np.float64)
        sum_rgb = st.sum_rgb.astype(np.float64)
        label_id = st.label_id
        mean_pre = st.mean_pre.astype(np.float64)
        flat = st.labels.reshape(-1)
        candf = st.candidate.reshape(-1)
        planes = []
        # ascending label order = PCL's region discovery (scan) order, the
        # order getPlanesStereo's loop visits regions in: the local merge
        # absorbs into the FIRST earlier match
        for k in sorted(range(len(label_id)), key=lambda i: label_id[i]):
            n = int(count[k])
            if n < MIN_INLIERS_STEREO:
                continue  # rows are count-sorted, but we walk label order
            inl = np.flatnonzero(flat == label_id[k])
            plane = Plane(
                id=len(planes),
                # reported params are the segment-stage fit; the refined-
                # member centroid rides along as merge suffstats
                normal=normal[k].copy(),
                center=mean_pre[k].copy(),
                curvature=float(curvature[k]),
                inliers=inl,
                n_pts=n,
                cov=cov[k].copy(),
                ss_center=mean[k].copy(),
            )
            plane.compute_hull_area(xyzf[inl[candf[inl]]].astype(np.float64))
            if plane.area_hull < default_params.min_area_plane:  # :938
                continue
            plane.d = float(-plane.normal @ plane.center)
            if plane.elongation > default_params.max_elongation_plane:  # :945
                continue
            total = hist[k].sum()
            plane.hist_counts = hist[k].copy()
            plane.hist_h = hist[k] / total if total > 0 else hist[k]
            plane.main_color = sum_rgb[k] / max(n, 1) / 255.0
            planes.append(plane)

        # local same-plane merge (:959-978)
        self.planes = PbMap(local_same_plane_merge(planes))
        return self.planes

    def build_sphere_cloud(self, start_phi: int = 166, max_depth: float = 15.0):
        """The stereo variant's own spherical backprojection (reference
        Frame360_stereo.h:454-517), a different convention from Frame360:
        phi = (row + start_phi) * step - pi/2, theta = col * step - pi,
        valid depth in (0, 15) m, invalid points NaN. Returns numpy
        (xyz (h*w, 3), rgb (h*w, 3) RGB), as the JAX method."""
        xyz = stereo_cloud(self.depth_m(), start_phi, max_depth).cpu().numpy()
        rgb = self.sphere_rgb.cpu().numpy()[..., ::-1]  # BGR -> RGB
        self.sphere_cloud = (xyz.reshape(-1, 3), rgb.reshape(-1, 3))
        return self.sphere_cloud
