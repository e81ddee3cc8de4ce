"""Per-frame plane extraction: Frame360.getPlanes equivalent.

Counterpart of rgbd360_tpu/core/plane_extraction.py (reference
include/Frame360.h:467-510 buildSphereCloud + :615-638 getPlanes +
:942-1081 getPlanesSensor + :742-832 groupPlanes + :657-739 mergePlanes):

  device (one batched program over the 8 sensors, on the frame's device):
      undistorted depth -> pinhole backprojection -> 2x median downsample ->
      fast bilateral (z) -> integral-image normals -> plane label
      propagation -> per-label statistics, packed into ONE u8 buffer
  host (numpy, copied from the JAX module):
      per-component plane parameters -> area/elongation filters -> per-sensor
      same-plane merge -> transform to rig frame -> cross-sensor groupPlanes
      (with the 8->1 wraparound) -> global mergePlanes

The JAX device program is XLA code; here it is plain torch ops, but for
the label refinement's growth loop, which runs on the card in one kernel
launch (ops/planes_seg.py::grow_labels, csrc/planes_refine.cu). Constants
from include/Miscellaneous.h:51-76 via config.GlobalParams.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np
import torch

from rgbd360_torch.config import default_params
from rgbd360_torch.core.pbmap import PbMap, Plane, dist3d_segment_segment_batch
from rgbd360_torch.ops.bilateral import fast_bilateral_z
from rgbd360_torch.ops.normals import organized_normals
from rgbd360_torch.ops.pinhole import backproject_organized, downsample_median2
from rgbd360_torch.ops.plane_stats import MAX_LABELS, sensor_plane_stats
from rgbd360_torch.ops.planes_seg import MIN_INLIERS, refine_plane_labels, segment_planes
from rgbd360_torch.utils.timing import stage

MAX_CURVATURE = default_params.max_curvature_plane
MIN_AREA = default_params.min_area_plane
MAX_ELONGATION = default_params.max_elongation_plane


def _sensor_clouds(depth_undist_m: torch.Tensor, rgb: torch.Tensor):
    """The shared head of the device program: (8,H,W) depth + (8,H,W,3) u8
    -> half-res clouds, colors, normals, pre- and post-refine labels, all
    in sensor frames."""
    xyz = backproject_organized(depth_undist_m)
    xyz2, rgb2 = downsample_median2(xyz, rgb)
    zf = fast_bilateral_z(xyz2[..., 2])
    xyz2 = torch.cat([xyz2[..., :2], zf[..., None]], dim=-1)
    normals = organized_normals(xyz2)
    labels_pre = segment_planes(xyz2, normals)
    # PCL segmentAndRefine's boundary refinement (Frame360.h:977)
    labels = refine_plane_labels(labels_pre, xyz2, normals)
    return xyz2, rgb2, normals, labels_pre, labels


def build_sensor_clouds(depth_undist_m: torch.Tensor, rgb: torch.Tensor):
    """(8,H,W) depth + (8,H,W,3) u8 -> per-sensor organized half-res clouds,
    normals and plane labels, all in sensor frames (plane_extraction.py:42)."""
    xyz2, rgb2, normals, _pre, labels = _sensor_clouds(depth_undist_m, rgb)
    return xyz2, rgb2, normals, labels


# Stats-buffer layout (plane_extraction.py:60-72), one packed u8 tensor and
# so one device-to-host copy per frame:
#   A: per-pixel (label+1)<<1 | candidate  (u16, or u32 for >2^15-px sensors)
#   B: compacted hull candidates: labels (8, C) u16/u32 (0 = empty slot) and
#      coordinates (8, C, 3) f16 — only the ~5% octagon-boundary pixels
#   C: per-label stats f32 (8, MAX_LABELS, _NF):
#      [label_id, count, mean(3), cov6(6), evals(3), normal(3), curvature,
#       hist(74), sum_rgb(3), mean_pre(3)]
#   D: per-sensor candidate counts (8,) i32 (overflow detection)
# Little-endian, as the host views it with numpy.
_NF = 98
MAX_CANDIDATES = 4096  # ~2.5x the max observed on the bundled frames (1607)


def compact_candidate_indices(candf: torch.Tensor, C: int) -> torch.Tensor:
    """Stream-compact a (S, hw) bool candidate mask into the first-C pixel
    indices per sensor (ascending order; hw marks an empty slot): a prefix
    sum and one batched scatter (plane_extraction.py:77)."""
    S, hw = candf.shape
    pix = torch.arange(hw, dtype=torch.int64, device=candf.device).expand(S, hw)
    pos = torch.cumsum(candf.to(torch.int64), dim=1) - 1
    tgt = torch.where(candf & (pos < C), pos, C)  # slot C absorbs the rest
    out = torch.full((S, C + 1), hw, dtype=torch.int64, device=candf.device)
    return out.scatter(1, tgt, pix)[:, :C]


def _le_bytes(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Non-negative integers -> their little-endian u16/u32 bytes, flat."""
    x = x.to(torch.int64).reshape(-1, 1)
    shifts = torch.arange(0, 8 * nbytes, 8, device=x.device)
    return ((x >> shifts) & 0xFF).to(torch.uint8).reshape(-1)


def build_sensor_plane_stats(depth_undist_m: torch.Tensor, rgb: torch.Tensor, ship_labels: bool = True) -> torch.Tensor:
    """The device program: clouds -> segmentation -> per-label statistics
    and hull candidates, packed into ONE u8 tensor on the input's device
    (plane_extraction.py:96).

    ship_labels=False drops the per-pixel label image from the buffer and
    ships each candidate's label instead — enough to fit planes and hulls;
    per-pixel inlier indices are then unavailable
    (extract_frame_planes(need_inliers=False), the odometry/SLAM-loop
    configuration)."""
    xyz2, rgb2, _normals, labels_pre, labels = _sensor_clouds(depth_undist_m, rgb)
    st = sensor_plane_stats(xyz2, rgb2, labels, labels_pre)
    S, h, w = st.labels.shape
    hw = h * w
    idx_bytes = 2 if hw < 2**16 else 4
    bufs = []
    if ship_labels:
        labpack = ((st.labels.to(torch.int64) + 1) << 1) | st.candidate.to(torch.int64)
        bufs.append(_le_bytes(labpack, 2 if hw * 2 + 1 < 2**16 else 4))

    # compacted candidates, the first C in ascending pixel order
    C = MAX_CANDIDATES
    candf = st.candidate.reshape(S, hw)
    cidx = compact_candidate_indices(candf, C)
    slot_ok = cidx < hw
    cidx_safe = torch.clamp(cidx, max=hw - 1)
    cxyz = torch.gather(xyz2.reshape(S, hw, 3), 1, cidx_safe[..., None].expand(-1, -1, 3))
    # the f16 cast where JAX casts (plane_extraction.py:138): the rounding
    # fixes the hull vertices the host fit sees
    cxyz = torch.where(slot_ok[..., None], cxyz, torch.full((), float("nan"), device=cxyz.device)).to(torch.float16)
    # per-candidate label (label + 1, 0 = empty slot / unlabeled pixel)
    clab = torch.gather(st.labels.reshape(S, hw), 1, cidx_safe)
    clab = torch.where(slot_ok, clab.to(torch.int64) + 1, 0)
    n_cand = candf.sum(1).to(torch.int32)  # true counts (overflow check)
    cov6 = st.cov.reshape(S, MAX_LABELS, 9)[..., [0, 1, 2, 4, 5, 8]]
    stats = torch.cat(
        [st.label_id[..., None].to(torch.float32), st.count[..., None].to(torch.float32), st.mean, cov6,
         st.evals, st.normal, st.curvature[..., None], st.hist, st.sum_rgb, st.mean_pre],
        dim=-1,
    )  # (S, K, _NF)
    bufs += [
        _le_bytes(clab, idx_bytes),
        cxyz.contiguous().view(torch.uint8).reshape(-1),
        stats.contiguous().view(torch.uint8).reshape(-1),
        n_cand.contiguous().view(torch.uint8).reshape(-1),
    ]
    return torch.cat(bufs)


def _unpack_stats_buffer(buf: np.ndarray, h: int, w: int, ship_labels: bool = True):
    """Host-side views into the packed stats buffer (no copies).
    Returns (labels-or-None, cand_lab, cand_xyz, stats, n_cand)."""
    hw = h * w
    C = MAX_CANDIDATES
    lab_dtype = np.uint16 if hw * 2 + 1 < 2**16 else np.uint32
    idx_dtype = np.uint16 if hw < 2**16 else np.uint32
    labels = None
    off = 0
    if ship_labels:
        nA = 8 * hw * lab_dtype().itemsize
        lab = buf[:nA].view(lab_dtype).reshape(8, h, w)
        labels = (lab >> 1).astype(np.int32) - 1
        off = nA
    nI = 8 * C * idx_dtype().itemsize
    nX = 8 * C * 3 * 2
    nS = 8 * MAX_LABELS * _NF * 4
    cand_lab = buf[off : off + nI].view(idx_dtype).reshape(8, C).astype(np.int64) - 1
    off += nI
    cand_xyz = buf[off : off + nX].view(np.float16).reshape(8, C, 3)
    off += nX
    stats = buf[off : off + nS].view(np.float32).reshape(8, MAX_LABELS, _NF)
    n_cand = buf[off + nS :].view(np.int32)
    return labels, cand_lab, cand_xyz, stats, n_cand


def local_same_plane_merge(planes: List[Plane]) -> List[Plane]:
    """Per-sensor same-plane absorption right after extraction (reference
    getPlanesSensor tail, include/Frame360.h:1055-1068; the stereo variant
    repeats it at Frame360_stereo.h:959-978): each low-curvature plane is
    merged into the first earlier plane it coincides with (0.99 normal dot,
    0.05 m offset, 0.2 m hull proximity)."""
    merged: List[Plane] = []
    for plane in planes:
        absorbed = False
        if plane.curvature < MAX_CURVATURE:
            for prev in merged:
                if prev.curvature < MAX_CURVATURE and prev.is_same_plane(
                    plane, 0.99, 0.05, 0.2
                ):
                    prev.merge_plane(plane)
                    absorbed = True
                    break
        if not absorbed:
            plane.id = len(merged)
            merged.append(plane)
    return merged


def _planes_from_stats(
    stats: np.ndarray,  # (MAX_LABELS, _NF) one sensor's stat rows
    labels: Optional[np.ndarray],  # (H, W) i32 or None (need_inliers=False)
    cand_lab: np.ndarray,  # (C,) candidate labels (-1 = empty slot)
    cand_xyz: np.ndarray,  # (C, 3) f16 candidate coordinates
    sensor_id: int,
    hw: int,
) -> List[Plane]:
    """Device stats -> Plane objects (the fast path of the reference
    getPlanesSensor loop, include/Frame360.h:979-1075): per-component
    centroid/covariance/eigendecomposition come from the device; the host
    runs only the exact hull over the device's octagon candidates, the
    area/elongation filters and the local merge."""
    if labels is not None:
        flat = labels.reshape(-1)
        valid = flat >= 0
        px = np.flatnonzero(valid)
        lv = flat[valid]
        order = np.argsort(lv, kind="stable")
        sorted_px = px[order]
        sorted_lab = lv[order]
    # group candidate points by their label
    slot_ok = cand_lab >= 0
    clab = cand_lab[slot_ok]
    cxyz = cand_xyz[slot_ok].astype(np.float64)
    corder = np.argsort(clab, kind="stable")
    sorted_cl = clab[corder]
    sorted_cxyz = cxyz[corder]

    label_id = stats[:, 0].astype(np.int64)
    count = stats[:, 1].astype(np.int64)
    mean = stats[:, 2:5].astype(np.float64)  # refined members (suffstats)
    cov6 = stats[:, 5:11].astype(np.float64)
    evals = stats[:, 11:14].astype(np.float64)
    normal = stats[:, 14:17].astype(np.float64)
    curvature = stats[:, 17].astype(np.float64)
    hist = stats[:, 18:92].astype(np.float64)
    sum_rgb = stats[:, 92:95].astype(np.float64)
    mean_pre = stats[:, 95:98].astype(np.float64)  # reported center (pre fit)

    planes: List[Plane] = []
    # ascending label order = PCL's region discovery (scan) order, which is
    # the order the reference's getPlanesSensor loop visits regions in —
    # local_same_plane_merge absorbs into the FIRST earlier match, so plane
    # ORDER changes merge pairings (the top-K rows arrive count-sorted; a
    # count-ordered walk produced different local merges than the oracle)
    for k in sorted(range(len(label_id)), key=lambda i: label_id[i]):
        n = int(count[k])
        if n < MIN_INLIERS:
            continue  # top-K rows are count-sorted, but we walk label order
        if labels is not None:
            a = np.searchsorted(sorted_lab, label_id[k], side="left")
            b = np.searchsorted(sorted_lab, label_id[k], side="right")
            inl = sorted_px[a:b] + sensor_id * hw
        else:
            inl = None
        cov = np.empty((3, 3))
        cov[0, 0], cov[0, 1], cov[0, 2] = cov6[k, 0], cov6[k, 1], cov6[k, 2]
        cov[1, 1], cov[1, 2], cov[2, 2] = cov6[k, 3], cov6[k, 4], cov6[k, 5]
        cov[1, 0], cov[2, 0], cov[2, 1] = cov[0, 1], cov[0, 2], cov[1, 2]
        plane = Plane(
            id=len(planes),
            normal=normal[k].copy(),
            center=mean_pre[k].copy(),  # reported params: segment-stage fit
            curvature=float(curvature[k]),
            inliers=inl,
            n_pts=n,
            cov=cov,
            ss_center=mean[k].copy(),  # merge suffstats: refined members
        )
        ca = np.searchsorted(sorted_cl, label_id[k], side="left")
        cb = np.searchsorted(sorted_cl, label_id[k], side="right")
        cpts = sorted_cxyz[ca:cb]
        # exact small-plane prefilter: the convex hull lies inside the
        # candidate bounding box in the SAME in-plane basis the hull uses,
        # so bbox area < MIN_AREA implies hull area < MIN_AREA — the same
        # discard (:1034) without paying the hull chain + mass-center +
        # elongation for the many sub-threshold clutter components
        # (~60-70% of the per-frame hull calls on the bundled frames)
        if len(cpts) >= 3:
            u_b, v_b = plane.plane_basis()
            rel = cpts - plane.center
            pu = rel @ u_b
            pv = rel @ v_b
            if (pu.max() - pu.min()) * (pv.max() - pv.min()) < MIN_AREA:
                continue
        plane.compute_hull_area(cpts)
        if plane.area_hull < MIN_AREA:  # discard small planes (:1034)
            continue
        plane.d = float(-plane.normal @ plane.center)
        if plane.elongation > MAX_ELONGATION:  # discard narrow planes (:1041)
            continue
        total = hist[k].sum()
        plane.hist_counts = hist[k].copy()
        plane.hist_h = hist[k] / total if total > 0 else hist[k]
        plane.main_color = sum_rgb[k] / max(n, 1) / 255.0
        planes.append(plane)

    return local_same_plane_merge(planes)


def _planes_from_labels(
    xyz: np.ndarray, rgb: np.ndarray, labels: np.ndarray, sensor_id: int
) -> List[Plane]:
    """Component stats -> Plane objects (reference getPlanesSensor loop,
    include/Frame360.h:979-1075), still in the sensor frame: the host fit
    from a label image the device made, each plane fitted from its own
    points (plane_extraction.py:321, copied; the ToF calibrator's path)."""
    h, w = labels.shape
    flat = labels.reshape(-1)
    xyzf = xyz.reshape(-1, 3)
    rgbf = rgb.reshape(-1, 3)
    valid = flat >= 0
    ids, inverse, counts = np.unique(flat[valid], return_inverse=True, return_counts=True)
    planes: List[Plane] = []
    px_of = np.flatnonzero(valid)
    order = np.argsort(inverse, kind="stable")
    sorted_px = px_of[order]
    boundaries = np.concatenate([[0], np.cumsum(counts)])
    single_cloud_size = h * w

    for k in range(len(ids)):
        if counts[k] < MIN_INLIERS:
            continue
        inl = sorted_px[boundaries[k] : boundaries[k + 1]]
        pts = xyzf[inl]
        center = pts.mean(axis=0)
        cov = (pts - center).T @ (pts - center) / len(pts)
        evals, evecs = np.linalg.eigh(cov)
        normal = evecs[:, 0]
        if normal @ center > 0:  # flip toward the sensor (Frame360.h:988-992)
            normal = -normal
        curvature = float(evals[0] / max(evals.sum(), 1e-12))

        plane = Plane(
            id=len(planes),
            normal=normal,
            center=center,
            curvature=curvature,
            inliers=inl + sensor_id * single_cloud_size,
            points=pts,
            colors=rgbf[inl],
        )
        plane.compute_hull_area(pts)
        if plane.area_hull < MIN_AREA:  # discard small planes (:1034)
            continue
        plane.d = float(-plane.normal @ plane.center)
        if plane.elongation > MAX_ELONGATION:  # discard narrow planes (:1041)
            continue
        plane.compute_colors()
        planes.append(plane)

    return local_same_plane_merge(planes)


def _same_surface(pj: Plane, pk: Plane, max_dist_hull: float, max_parallel: float) -> bool:
    """The vertex/edge proximity + parallel-offset test shared by groupPlanes
    and mergePlanes (reference include/Frame360.h:680-711, 785-811)."""
    h1, h2 = pj.hull, pk.hull
    if h1 is None or h2 is None or len(h1) < 2 or len(h2) < 2:
        return False
    diff = h1[:, None, :] - h2[None, :, :]
    dist = np.linalg.norm(diff, axis=-1)
    offset = np.abs(diff @ pj.normal)
    if np.any((dist < max_dist_hull) & (offset < max_parallel)):
        return True
    # edge-to-edge distances, all pairs at once (the scalar per-pair loop
    # was the hottest remaining host op of plane extraction)
    thr2 = max_dist_hull * max_dist_hull
    d2 = dist3d_segment_segment_batch(
        h1, np.roll(h1, -1, axis=0), h2, np.roll(h2, -1, axis=0)
    )
    return bool(np.any((d2 < thr2) & (offset < max_parallel)))


def group_planes(local_planes: List[List[Plane]]) -> PbMap:
    """Cross-sensor merge incl. the sensor 7->0 wraparound
    (reference include/Frame360.h:742-832)."""
    max_dist_hull = 0.5
    max_parallel = 0.09
    planes: List[Plane] = []
    for p in local_planes[0]:
        p.id = len(planes)
        planes.append(p)
    first_ids = {p.id for p in planes}
    prev_ids = set(first_ids)

    for sensor_id in range(1, 8):
        next_prev = set()
        for cand in local_planes[sensor_id]:
            target = None
            if cand.area_hull > 0.5 or cand.curvature < MAX_CURVATURE:
                # ascending id order: the reference iterates std::set<unsigned>
                # and merges into the FIRST match (:766-817) — when several
                # previous planes match, the target is order-dependent, and a
                # Python set's iteration order is not a contract
                for j in sorted(prev_ids):
                    pj = planes[j]
                    if pj.area_hull < 0.5 or pj.curvature > MAX_CURVATURE:
                        continue
                    if abs(pj.d - cand.d) >= 0.45:
                        continue
                    if pj.normal @ cand.normal <= 0.99:
                        continue
                    if _same_surface(pj, cand, max_dist_hull, max_parallel):
                        target = j
                        break
            if target is not None:
                next_prev.add(target)
                planes[target].merge_plane(cand)
            else:
                cand.id = len(planes)
                next_prev.add(cand.id)
                planes.append(cand)
        prev_ids = next_prev
        if sensor_id == 6:  # let sensor 7 also merge with sensor 0's planes
            prev_ids |= first_ids
    return PbMap(planes=planes)


def merge_planes(pbmap: PbMap) -> PbMap:
    """Global merge of coplanar patches (reference include/Frame360.h:657-739)."""
    planes = pbmap.planes
    j = 0
    while j < len(planes):
        k = j + 1
        merged_any = False
        while k < len(planes):
            pj, pk = planes[j], planes[k]
            same = False
            if pj.curvature < MAX_CURVATURE and pk.curvature < MAX_CURVATURE:
                if pj.normal @ pk.normal > 0.99 and abs(pj.d - pk.d) < 0.45:
                    same = _same_surface(pj, pk, 0.3, 0.06)
            if same:
                pj.merge_plane(pk)
                del planes[k]
                # (ids are reassigned wholesale after the merge loop)
                merged_any = True
                break  # re-evaluate j against all (reference :729-731)
            k += 1
        if not merged_any:
            j += 1
    for i, p in enumerate(planes):
        p.id = i
    return pbmap


def _fit_from_stats_buffer(frame, buf: np.ndarray, need_inliers: bool):
    """Host half of the getPlanes pipeline: unpack a fetched device stats
    buffer, fit per-sensor planes, transform to rig frame, group and merge.
    Shared by extract_frame_planes and planes_pipeline.collect so the
    overflow warnings and merge semantics exist exactly once."""
    h, w = frame.depth_undistorted_m.shape[1] // 2, frame.depth_undistorted_m.shape[2] // 2
    labels, cand_lab, cand_xyz, stats, n_cand = _unpack_stats_buffer(
        buf, h, w, ship_labels=need_inliers
    )
    if stats[:, -1, 1].max() >= MIN_INLIERS:
        print(
            "[plane_extraction] WARNING: >MAX_LABELS plane components on a "
            "sensor — smallest ones dropped (raise ops/plane_stats.MAX_LABELS)"
        )
    if n_cand.max() > MAX_CANDIDATES:
        print(
            f"[plane_extraction] WARNING: {int(n_cand.max())} hull candidates "
            f"on a sensor exceed the {MAX_CANDIDATES} shipping budget — hulls "
            "may shrink slightly (raise MAX_CANDIDATES)"
        )
    rt = frame.calib.Rt

    local: List[List[Plane]] = []
    for s in range(8):
        planes = _planes_from_stats(
            stats[s],
            labels[s] if labels is not None else None,
            cand_lab[s],
            cand_xyz[s],
            s,
            h * w,
        )
        for p in planes:
            p.transform(rt[s].astype(np.float64))
        local.append(planes)

    # the global merge MUTATES planes (merge_plane re-estimates
    # normal/center/d/hull from cross-sensor point unions and rewrites ids);
    # local_planes must stay pristine per-sensor observations like the
    # reference's value-semantics copies (Frame360.h:742-832) — the
    # calibration apps derive adjacent-sensor correspondences from them, and
    # aliased merged planes would bias the solve toward the current Rt
    if not need_inliers:
        # SLAM-loop configuration: nothing consumes per-sensor observations
        # (only calibrate_rig does, and it runs the default mode), so merge
        # the originals and skip the pristine copies
        return merge_planes(group_planes(local)), None
    pbmap = merge_planes(group_planes([[copy.deepcopy(p) for p in l] for l in local]))
    return pbmap, local



class HostCopy:
    """A device stats buffer on its way to the host. On a CUDA device the
    copy into pinned host memory is enqueued behind the program that makes
    the buffer, and a CUDA event marks its end: ``result()`` (on any
    thread) waits for that event only. On the CPU the buffer is already on
    the host. Stands in for the JAX array's ``copy_to_host_async`` +
    ``np.asarray`` (plane_extraction.py:623-641)."""

    def __init__(self, buf: torch.Tensor):
        self._dev = buf  # kept alive until the copy has run
        if buf.device.type == "cuda":
            self._host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            self._host.copy_(buf, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = buf, None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def extract_frame_planes(frame, need_inliers: bool = True) -> Tuple[PbMap, List[List[Plane]]]:
    """Full getPlanes pipeline for a Frame360 (plane_extraction.py:520).

    need_inliers=False skips the per-pixel label image (Plane.inliers stays
    None) — the odometry/SLAM-loop configuration, where only plane geometry,
    hulls and histograms are consumed; calibration and labelization keep
    the default."""
    with stage("planes device program", sync=frame._sync):
        copy_ = HostCopy(build_sensor_plane_stats(frame.depth_undistorted_m, frame.rgb, ship_labels=need_inliers))
    with stage("planes collect (sync)"):
        buf = copy_.result()
    with stage("planes host fit"):
        return _fit_from_stats_buffer(frame, buf, need_inliers)


def fused_frame_program(rgb, depth_raw_mm, mults, counts, maps, *, ship_labels: bool,
                        bin_width: int, bin_height: int, bin_depth: float):
    """The whole per-frame device pipeline in one call: CLAMS undistort +
    spherical stitch (+ gray) + plane stats (plane_extraction.py:539). Each
    stage is the function the step-by-step path runs, so the outputs are
    the same; ``maps`` are the stitch maps of the frame's calibration
    (ops/stitch.py::stitch_maps)."""
    from rgbd360_torch.ops.image import gray_f32
    from rgbd360_torch.ops.stitch import stitch_with_maps
    from rgbd360_torch.ops.undistort import undistort_depth_mm

    depth_und = undistort_depth_mm(depth_raw_mm, mults, counts, bin_width=bin_width, bin_height=bin_height, bin_depth=bin_depth)
    sphere_rgb, sphere_depth_mm = stitch_with_maps(rgb, depth_raw_mm, maps)
    sphere_gray = gray_f32(sphere_rgb)
    stats = build_sensor_plane_stats(depth_und, rgb, ship_labels=ship_labels)
    return sphere_rgb, sphere_depth_mm, sphere_gray, depth_und, stats


def planes_pipeline(frames_iter, need_inliers: bool = False, pre_collect=None, threaded: bool = True):
    """One-frame-lookahead plane extraction over a (frame_no, frame)
    iterator (plane_extraction.py:573): frame N+1's device program is
    dispatched BEFORE frame N's buffer is collected and host-fitted. Yields
    (frame_no, frame) with frame.planes / frame.local_planes set, exactly
    as the sequential frame.get_planes(need_inliers=...) would.

    pre_collect(frame): optional hook called with frame N (panorama built)
    on the caller's thread, in frame order, before frame N is yielded.
    CONTRACT: the hook must not read frame.planes / frame.local_planes — in
    the threaded default the worker may already be fitting (or have fitted)
    them when the hook runs; only in sequential mode is the hook strictly
    pre-fit.

    threaded (default on; the JAX function also reads it from the
    environment, RGBD360_PIPELINE_THREAD, which the port does not): each
    frame's collect (a wait on the CUDA event behind its host copy) and host plane
    fit run on ONE daemon worker thread, submitted right after that frame's
    dispatch and joined at yield time. The worker runs host code only
    (HostCopy.result + _fit_from_stats_buffer, numpy) and touches only its
    own frame's attributes; every device dispatch — the pre_collect hook
    included — stays on the caller's thread in the sequential order, so the
    yielded plane sets are the same as sequential.

    Each stage carries the ``frame`` attr (utils/timing.py) of the frame it
    works on, on either thread; of the threaded mode's stages only "planes
    join (thread)" waits on the caller's thread."""
    def dispatch(frame):
        if getattr(frame, "_deferred_build", False):
            # deferred-build frame (sequence_frames(defer_device=True) sets
            # the explicit marker): undistort + stitch + stats in one call.
            # The marker — not attribute sniffing — gates this path, so
            # frames whose depth must not be CLAMS-undistorted never route
            # here by accident.
            buf = frame.build_device_fused(ship_labels=need_inliers)
        else:
            buf = build_sensor_plane_stats(frame.depth_undistorted_m, frame.rgb, ship_labels=need_inliers)
        # the device->host copy is enqueued NOW, right behind the program
        return HostCopy(buf)

    def collect(frame_no, frame, copy_):
        # on the worker thread: the frame attr ties these to its other spans
        with stage("planes collect (sync)", frame=frame_no):
            buf = copy_.result()
        with stage("planes host fit", frame=frame_no):
            frame.planes, frame.local_planes = _fit_from_stats_buffer(frame, buf, need_inliers)
        return frame_no, frame

    def hook(frame):
        if pre_collect is not None:
            with stage("speculative align dispatch"):
                pre_collect(frame)

    if threaded:
        # a DAEMON worker, not a ThreadPoolExecutor: a worker stuck in a wait
        # must not make the app unkillable by normal exit (the executor's
        # exit handler joins its non-daemon threads)
        import queue
        import threading
        from concurrent.futures import Future

        q: "queue.Queue" = queue.Queue()

        def worker():
            while True:
                item = q.get()
                if item is None:
                    return
                fut_out, frame_no, frame, copy_ = item
                try:
                    fut_out.set_result(collect(frame_no, frame, copy_))
                except BaseException as e:  # surfaced at .result()
                    fut_out.set_exception(e)

        th = threading.Thread(target=worker, name="planes-fit", daemon=True)
        th.start()
        try:
            pending = None
            for frame_no, frame in frames_iter:
                if pending is not None:
                    hook(pending[1])
                with stage("planes dispatch", frame=frame_no):
                    copy_ = dispatch(frame)
                task = Future()
                q.put((task, frame_no, frame, copy_))
                if pending is not None:
                    with stage("planes join (thread)", frame=pending[0]):
                        item = pending[2].result()
                    yield item
                pending = (frame_no, frame, task)
            if pending is not None:
                hook(pending[1])
                with stage("planes join (thread)", frame=pending[0]):
                    item = pending[2].result()
                yield item
        finally:
            q.put(None)
        return

    pending = None
    for frame_no, frame in frames_iter:
        # hook BEFORE dispatching frame N+1's stats so the speculative work
        # of frame N sits ahead of them in the device queue
        if pending is not None:
            hook(pending[1])
        with stage("planes dispatch", frame=frame_no):
            copy_ = dispatch(frame)
        if pending is not None:
            yield collect(*pending)
        pending = (frame_no, frame, copy_)
    if pending is not None:
        hook(pending[1])
        yield collect(*pending)
