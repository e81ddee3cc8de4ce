"""Keyframe-selection SLAM tracker — the KFsphere_SLAM semantics
(reference SLAM/KFsphere_SLAM.cpp:197-793).

Counterpart of rgbd360_tpu/core/kf_slam.py: the host logic is a copy; the
dense aligns run through the port's RegisterPhotoICP facade on ``device``
(the card unless the caller names another). The speculative tracking align
(``prefetch_align``) goes through the facade's ``dispatch_frames360``,
which in the port runs the whole align before it returns (one host sync
per Gauss-Newton iteration): it moves the align earlier, and overlaps
nothing. So the tracker counts its speculative aligns — dispatched,
consumed and wasted (``speculative_counts``) — for the measurement that
decides whether speculation pays in the port.

The reference's active loop (not the commented-out variants) per frame:

  1. PbMap-register against the nearest keyframe (PLANAR_3DoF).
     Strong match (>=6 planes and matched area > 12) -> skip the frame,
     keeping the conjugated PbMap pose as the next dense seed (:354-367).
  2. Otherwise dense-align against the nearest KF seeded by the running
     sphere-frame seed; avDepthResidual < 0.9 with continuous motion
     (< 0.2 m step) -> skip the frame (:370-398, threshold set :284-286).
  3. Otherwise the frame is a keyframe candidate: scan all keyframes of the
     current area + neighbor submaps within 2.5 m of the candidate pose
     (:400-412); dense-align each; residual < 0.9 -> the camera is actually
     near that KF: skip the frame and possibly switch nearestKF (:435-469);
     residual < 1.8 -> keep a dense connection edge; an additional PbMap
     registration with >5 matches and area > 25 adds a plane edge (:437-460).
  4. Select the keyframe: g2o vertex + dense edge to nearestKF, plus a second
     PbMap edge when the tracking PbMap pose agrees with the dense pose
     within 5 deg / 10 cm (:542-553); map + SSO bookkeeping (:560-631);
     collected connections become extra edges and mark a new loop closure
     (:625-631) which triggers graph optimization (:674-700); spectral
     re-partitioning every 4 local keyframes (:710-712).

Deviation noted: the reference's dual-edge check reads the matcher state
left over from the *last* RegisterPbMap call of the nearby-KF scan; this
implementation snapshots the tracking registration's matches/area/pose/info
before the scan, which is the stated intent of the `bGoodTracking` guard.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from rgbd360_torch.core.graph_optimizer import GraphOptimizer
from rgbd360_torch.core.map360 import Map360
from rgbd360_torch.core.matcher import PLANAR_3DOF
from rgbd360_torch.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP

# (method, occlusion, full_coverage) of the dense tracking alignment — the
# SINGLE source for prefetch_align's speculative dispatch, _dense_align's
# synchronous call AND the reuse-key comparison, so the speculative result
# can never be reused by a differently-configured alignment (changing the
# tracking config here changes all three together).
_TRACK_CFG = (PHOTO_DEPTH, 0, False)
from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360
from rgbd360_torch.core.topological import TopologicalMap360

# Reference constants (KFsphere_SLAM.cpp:284-287, 354, 437, 452, 546-547, 710)
SELECT_KF_ICP_DIST = 0.9
THRESHOLD_CONNECTIONS = 2.5
CONTINUOUS_MOTION_DIST = 0.2
STRONG_PBMAP_MATCHES = 6
STRONG_PBMAP_AREA = 12.0
KEEP_CONNECTION_RESIDUAL = 1.8
LC_PBMAP_MATCHES = 5  # strictly greater (:452)
LC_PBMAP_AREA = 25.0
DUAL_EDGE_MATCHES = 4
DUAL_EDGE_AREA = 6.0
DUAL_EDGE_ROT_DEG = 5.0
DUAL_EDGE_TRANS = 0.1
PARTITION_EVERY = 4


def is_continuous_motion(prev_pose: np.ndarray, curr_pose: np.ndarray,
                         thres_dist: float = CONTINUOUS_MOTION_DIST) -> bool:
    """isOdometryContinuousMotion (KFsphere_SLAM.cpp:119-126)."""
    rel = np.linalg.inv(prev_pose) @ curr_pose
    return float(np.linalg.norm(rel[:3, 3])) <= thres_dist


def diff_rotation_deg(pose_a: np.ndarray, pose_b: np.ndarray) -> float:
    """diffRotation (reference include/Miscellaneous.h:127-140): a
    per-keyframe host scalar, in numpy."""
    cos = (np.trace(pose_a[:3, :3].T @ pose_b[:3, :3]) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def dif_translation(pose_a: np.ndarray, pose_b: np.ndarray) -> float:
    """difTranslation (reference include/Miscellaneous.h:142-149)."""
    return float(np.linalg.norm(pose_a[:3, 3] - pose_b[:3, 3]))


class KFSphereSLAM:
    """Per-frame keyframe-selection tracker. Drives Map360/TopologicalMap360/
    GraphOptimizer exactly as the reference loop does; returns a status string
    per frame for observability and testing."""

    def __init__(
        self,
        world: Optional[Map360] = None,
        matcher_config: Optional[str] = None,
        n_pyr_levels: int = 5,
        registerer: Optional[RegisterRGBD360] = None,
        aligner: Optional[RegisterPhotoICP] = None,
        optimizer: Optional[GraphOptimizer] = None,
        topo: Optional[TopologicalMap360] = None,
        speculative_align: bool = True,
        device=None,
    ):
        self.speculative_align = speculative_align
        self._spec = None  # (frame token, kf id, seed, cfg) of an in-flight dispatch
        self._spec_seq = 0  # monotone token stamped on prefetched frames; = aligns dispatched
        self._spec_hits = 0  # dispatched aligns consumed by process_frame
        self._last_kind = ""
        self.world = world if world is not None else Map360()
        # a resumed map must bring its topological SSO state along
        # (core/map_io.load_map_full) — a fresh TopologicalMap360 over a
        # populated map has empty v_sso and crashes on the first connection
        self.topo = topo if topo is not None else TopologicalMap360(self.world)
        self.optimizer = optimizer if optimizer is not None else GraphOptimizer(robust=True)
        self.registerer = registerer if registerer is not None else RegisterRGBD360(matcher_config)
        self.aligner = aligner if aligner is not None else RegisterPhotoICP(n_pyr_levels=n_pyr_levels, device=device)
        from rgbd360_torch.apps.common import rot_offset

        self.off = rot_offset()  # 157.5 deg conjugation (KFsphere_SLAM.cpp:290-292)
        self.off_inv = np.linalg.inv(self.off)
        self.nearest_kf = 0
        self.current_pose = np.eye(4, dtype=np.float64)  # pose of nearest_kf
        self.seed_ref = np.eye(4, dtype=np.float64)  # rigidTransf_dense_ref
        self.n_keyframes_selected = 0
        self.n_loop_closures = 0
        if len(self.world):  # resuming from a loaded map (core/map_io.py)
            # a resumed map needs a graph with matching vertices: a fresh
            # optimizer would hand out vertex ids starting at 0 while edges
            # reference keyframe ids up to len(world), crashing the first
            # optimize_graph — the same hazard the topo guard above covers
            assert self.optimizer.vertex_count() == len(self.world), (
                f"optimizer has {self.optimizer.vertex_count()} vertices for a "
                f"{len(self.world)}-keyframe map — resume via "
                "core/map_io.load_map_full, which restores the graph too"
            )
            self.nearest_kf = len(self.world) - 1
            self.current_pose = self.world.trajectory_poses[-1].astype(np.float64)
            self.n_keyframes_selected = len(self.world)

    @property
    def speculative_counts(self) -> dict:
        """Speculative tracking aligns so far: dispatched by prefetch_align,
        consumed by process_frame, and wasted (never read: the frame was
        PbMap-tracked, or the key no longer matched)."""
        return {"dispatched": self._spec_seq, "consumed": self._spec_hits,
                "wasted": self._spec_seq - self._spec_hits}

    # ------------------------------------------------------------------ dense
    def prefetch_align(self, frame) -> None:
        """Speculatively dispatch the step-2 tracking alignment (vs the
        current nearest KF, seeded by the running sphere-frame seed) ahead of
        process_frame (planes_pipeline's pre_collect hook calls this). In the
        JAX package the dispatch is asynchronous and overlaps the plane-stats
        transfer and host plane fit; in the port dispatch_frames360 returns
        after the align (see the module docstring). The dispatch uses exactly
        the state step 2 will read — nearest_kf and seed_ref are only mutated by process_frame —
        so _dense_align reuses the in-flight result when it matches and the
        outcome is identical to the unprefetched loop. If PbMap tracking
        then skips the frame, the result is simply never fetched.

        Adaptive, as in JAX: skipped right after a PbMap-tracked frame
        (streaks of strong PbMap tracking never reach step 2, and the wasted
        align would sit on the frame's critical path). The policy is the
        JAX package's; its counts on the card are in PERF.md."""
        if len(self.world) == 0 or not self.speculative_align:
            return
        if self._last_kind == "skip_pbmap":
            return
        kf = self.world.frames[self.nearest_kf]
        self.aligner.set_target_frame(kf.sphere_rgb, kf.sphere_depth_mm)
        self.aligner.set_source_frame(frame.sphere_rgb, frame.sphere_depth_mm)
        # capture the ACTUAL values handed to dispatch (not the module
        # constant) so the spec key records what was dispatched; _dense_align
        # compares them against the values IT is about to use — a future edit
        # that parameterizes either site's config is caught by the guard
        cfg = (_TRACK_CFG[0], _TRACK_CFG[1], _TRACK_CFG[2])
        self.aligner.dispatch_frames360(
            self.seed_ref.astype(np.float32), cfg[0],
            occlusion=cfg[1], full_coverage=cfg[2],
        )
        # the frame is identified by a monotone token stamped on the object,
        # NOT id(): a frame that is prefetched but never reaches process_frame
        # (e.g. the app catches a collect-time exception and continues) could
        # be GC'd and a NEW frame allocated at the same address — the token
        # attribute does not exist on the new object, so it can never match.
        # The key also records the dispatch configuration (_TRACK_CFG is the
        # single source for both the dispatch above and _dense_align's call).
        self._spec_seq += 1
        frame._spec_token = self._spec_seq
        self._spec = (
            self._spec_seq, self.nearest_kf, self.seed_ref.copy(), cfg,
        )

    def _dense_align(self, kf_id: int, frame, seed_sphere: np.ndarray,
                     reuse_source: bool = False):
        """reuse_source: the nearby-KF scan aligns the SAME source frame
        against several targets — rebuild only the target pyramid then."""
        spec = self._spec
        self._spec = None
        # the config THIS call will align with (mirrors prefetch_align's
        # capture — compare dispatched values vs about-to-use values, so the
        # guard is live if either site's config is ever parameterized)
        cfg = (_TRACK_CFG[0], _TRACK_CFG[1], _TRACK_CFG[2])
        if (
            spec is not None
            and spec[0] == getattr(frame, "_spec_token", None)
            and spec[1] == kf_id
            and np.array_equal(spec[2], seed_sphere)
            and spec[3] == cfg
        ):
            # the speculative dispatch IS this alignment — just read it
            self._spec_hits += 1
            ref_pose = self.aligner.get_optimal_pose().astype(np.float64)
            return ref_pose, self.off_inv @ ref_pose @ self.off
        kf = self.world.frames[kf_id]
        self.aligner.set_target_frame(kf.sphere_rgb, kf.sphere_depth_mm)
        if not reuse_source:
            self.aligner.set_source_frame(frame.sphere_rgb, frame.sphere_depth_mm)
        self.aligner.align_frames360(
            seed_sphere.astype(np.float32), cfg[0],
            occlusion=cfg[1], full_coverage=cfg[2],
        )
        ref_pose = self.aligner.get_optimal_pose().astype(np.float64)
        rel_cloud = self.off_inv @ ref_pose @ self.off
        return ref_pose, rel_cloud

    def _in_neighbour_submap(self, submap: int, kf: int) -> bool:
        """isInNeighbourSubmap (KFsphere_SLAM.cpp:110-117)."""
        for area in self.world.neighbor_areas[submap]:
            if kf in self.world.areas[area]:
                return True
        return False

    # ------------------------------------------------------------------ frame
    def process_frame(self, frame) -> str:
        try:
            kind = self._process_frame(frame)
        finally:
            # clear even on an exception: a stale entry could later match a
            # NEW frame object reallocated at the same id() and silently
            # hand it the aborted frame's alignment
            self._spec = None
            self._last_kind = "error"
        self._last_kind = kind
        return kind

    def _process_frame(self, frame) -> str:
        world = self.world
        if len(world) == 0:
            world.add_keyframe(frame, self.current_pose)
            world.optimized_poses.append(self.current_pose.astype(np.float32))
            self.topo.add_keyframe(world.current_area)
            self.optimizer.add_vertex(self.current_pose)
            self.nearest_kf = 0
            self.n_keyframes_selected += 1
            return "first_keyframe"

        # 1. PbMap tracking against the nearest keyframe (:314)
        good_tracking = self.registerer.register_pbmap(
            world.frames[self.nearest_kf], frame, 25, PLANAR_3DOF
        )
        tracked_pb = self.registerer.get_pose().astype(np.float64)
        tracked_matches = len(self.registerer.get_matched_planes())
        tracked_area = float(self.registerer.get_area_matched())
        tracked_info = self.registerer.get_info_mat().astype(np.float64)

        if good_tracking and tracked_matches >= STRONG_PBMAP_MATCHES and tracked_area > STRONG_PBMAP_AREA:
            self.seed_ref = self.off @ tracked_pb @ self.off_inv  # (:357)
            return "skip_pbmap"

        # 2. dense alignment against the nearest keyframe (:370-381)
        prev_ref = self.seed_ref
        ref_pose, rel_dense = self._dense_align(self.nearest_kf, frame, self.seed_ref)
        self.seed_ref = ref_pose
        depth_residual = self.aligner.av_depth_residual

        if depth_residual < SELECT_KF_ICP_DIST and is_continuous_motion(prev_ref, ref_pose):
            return "skip_tracked"

        # 3. candidate keyframe + nearby-KF connection scan (:400-470)
        candidate_rel = rel_dense
        candidate_info = self.aligner.get_hessian().astype(np.float64)
        candidate_sso = self.aligner.sso
        connections: List[Tuple[int, np.ndarray, np.ndarray, float]] = []
        for kf in range(len(world)):
            if kf == self.nearest_kf:
                continue
            node = world.frames[kf].node
            if not (node == world.current_area or self._in_neighbour_submap(world.current_area, kf)):
                continue
            kf_pose = world.trajectory_poses[kf].astype(np.float64)
            relative = np.linalg.inv(kf_pose) @ self.current_pose @ rel_dense
            if np.linalg.norm(relative[:3, 3]) >= THRESHOLD_CONNECTIONS:
                continue
            prev2 = self.seed_ref
            seed2 = self.off @ relative @ self.off_inv
            ref2, rel_kf = self._dense_align(kf, frame, seed2, reuse_source=True)
            self.seed_ref = ref2
            # reference :430 SKIPS when the new result sits WITHIN 0.2 m of
            # the previous one (the opposite sense of the skip-frame gate at
            # :388): prev2 is relative to the nearest KF and ref2 to the
            # scanned kf, so a near-zero difference means the aligner never
            # left the neighbourhood of the previous solution — a stuck /
            # degenerate result, not a genuine registration to kf. Round 3
            # fix: this was inverted (`if not is_continuous_motion`), which
            # rejected every scan candidate (the two KFs are necessarily
            # > 0.2 m apart) and made loop-closure connections unreachable.
            if is_continuous_motion(prev2, ref2):
                continue
            resid = self.aligner.av_depth_residual
            if resid < SELECT_KF_ICP_DIST:
                # the camera is actually near kf: skip the frame (:435-469)
                if resid < depth_residual:
                    self.current_pose = kf_pose
                    self.nearest_kf = kf
                else:
                    # tracking stays on the old nearest keyframe — ref2 is
                    # relative to the scanned kf and would poison the next
                    # frame's dense seed. Restore the STEP-2 result (relative
                    # to nearest_kf): prev2 would be the previous scan
                    # candidate's pose for the 2nd+ iteration, which is
                    # relative to the wrong keyframe too
                    self.seed_ref = ref_pose
                return "skip_near_kf"
            if resid < KEEP_CONNECTION_RESIDUAL:
                connections.append(
                    (kf, rel_kf, self.aligner.get_hessian().astype(np.float64), self.aligner.sso)
                )
            ok_pb = self.registerer.register_pbmap(world.frames[kf], frame, 25, PLANAR_3DOF)
            if (
                ok_pb
                and len(self.registerer.get_matched_planes()) > LC_PBMAP_MATCHES
                and self.registerer.get_area_matched() > LC_PBMAP_AREA
            ):
                connections.append(
                    (
                        kf,
                        self.registerer.get_pose().astype(np.float64),
                        float(self.registerer.get_area_matched())
                        * self.registerer.get_info_mat().astype(np.float64),
                        self.aligner.sso,
                    )
                )

        # 4. select the keyframe (:542-631)
        self.current_pose = self.current_pose @ candidate_rel
        new_id_expected = len(world)
        self.optimizer.add_vertex(self.current_pose)
        self.optimizer.add_edge(self.nearest_kf, new_id_expected, candidate_rel, candidate_info)
        if (
            good_tracking
            and tracked_matches >= DUAL_EDGE_MATCHES
            and tracked_area > DUAL_EDGE_AREA
            and diff_rotation_deg(tracked_pb, candidate_rel) < DUAL_EDGE_ROT_DEG
            and dif_translation(tracked_pb, candidate_rel) < DUAL_EDGE_TRANS
        ):
            self.optimizer.add_edge(self.nearest_kf, new_id_expected, tracked_pb, tracked_info)

        kf_id = world.add_keyframe(frame, self.current_pose)
        assert kf_id == new_id_expected
        world.optimized_poses.append(self.current_pose.astype(np.float32))
        world.add_connection(self.nearest_kf, kf_id, candidate_rel, candidate_info)
        self.topo.add_keyframe(world.current_area)
        # tracking SSO entry between the new KF and its predecessor (:620-624)
        self.topo.add_connection(self.nearest_kf, kf_id, float(candidate_sso))
        self.n_keyframes_selected += 1

        has_new_lc = False
        for kf, rel, info, sso in connections:
            world.add_connection(kf, kf_id, rel, info)
            self.topo.add_connection(kf, kf_id, float(sso))
            self.optimizer.add_edge(kf, kf_id, rel, info)
            has_new_lc = True
        if has_new_lc:
            self.n_loop_closures += len(connections)

        self.nearest_kf = kf_id
        self.seed_ref = np.eye(4, dtype=np.float64)

        if has_new_lc:
            # optimize the pose graph on new loop closures (:674-700)
            self.optimizer.optimize_graph()
            with world.mutex:
                world.optimized_poses = [p.astype(np.float32) for p in self.optimizer.get_poses()]
            self.current_pose = world.optimized_poses[-1].astype(np.float64)

        # spectral partitioning every 4 local keyframes (:710-712)
        local_id = world.local_index(kf_id)
        if local_id % PARTITION_EVERY == 0 and local_id > 0:
            self.topo.partitioner()

        return "keyframe+lc" if has_new_lc else "keyframe"
