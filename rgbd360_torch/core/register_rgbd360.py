"""RegisterRGBD360 — plane-based registration of two Frame360s, mirroring the
reference public API (include/RegisterRGBD360.h): setReference/setTarget with
top-K-area subgraphs, RegisterPbMap, getPose/getInfoMat/getAreaMatched/
getMatchedPlanes/calcEntropy/trackingScore.

Counterpart of rgbd360_tpu/core/register_rgbd360.py: its PbMap half copied
(host numpy over the frames' PbMaps), and its dense half,
register_dense_photoicp (the 8-camera robot-frame pinhole registration,
RegisterRGBD360.h:344-516), on the frames' device through
ops/photoicp_pinhole.py.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from rgbd360_torch.config import default_params
from rgbd360_torch.core.matcher import (
    DEFAULT_6DOF,
    PLANAR_3DOF,  # noqa: F401  (re-export, as the JAX module)
    ODOMETRY_6DOF,  # noqa: F401
    PLANAR_ODOMETRY_3DOF,  # noqa: F401
    MatcherConfig,
    SubgraphMatcher,
    estimate_pose_from_planes,
)

GOOD, WEAK, BAD = 0, 1, 2


class RegisterRGBD360:
    def __init__(self, config_file: Optional[str] = None):
        cfg = MatcherConfig.from_ini(config_file) if config_file else MatcherConfig()
        self.matcher = SubgraphMatcher(cfg)
        self.ref360 = None
        self.trg360 = None
        self._ref_idx = []
        self._trg_idx = []
        self.rigid_transf = np.eye(4, dtype=np.float32)
        self.information = np.zeros((6, 6), np.float32)
        self.best_match: Dict[int, int] = {}
        self.area_matched = 0.0
        self.area_source = 0.0
        self.area_target = 0.0
        self._done = False

    # -- subgraph selection (reference RegisterRGBD360.h:111-196) --------------
    @staticmethod
    def _select(frame, max_match_planes: int):
        planes = frame.planes.planes
        idx = [p.id for p in planes if p.curvature < default_params.max_curvature_plane]
        if max_match_planes and len(idx) > max_match_planes:
            # labeled planes are force-included (area tweaked to 10)
            def key(i):
                p = planes[i]
                return 10.0 if p.label else p.area_hull

            idx = sorted(idx, key=key, reverse=True)[:max_match_planes]
        return idx

    def set_reference(self, frame, max_match_planes: int = 0) -> None:
        self.ref360 = frame
        self._ref_idx = self._select(frame, max_match_planes)
        self._done = False

    def set_target(self, frame, max_match_planes: int = 0) -> None:
        self.trg360 = frame
        self._trg_idx = self._select(frame, max_match_planes)
        self._done = False

    # -- registration -----------------------------------------------------------
    def register_pbmap(self, frame1=None, frame2=None, max_match_planes: int = 0,
                       regist_mode: int = DEFAULT_6DOF) -> bool:
        """PbMap registration (reference RegisterRGBD360.h:276-341)."""
        if frame1 is not None:
            self.set_reference(frame1, max_match_planes)
        if frame2 is not None:
            self.set_target(frame2, max_match_planes)
        self._done = True

        ref_pb, trg_pb = self.ref360.planes, self.trg360.planes
        self.best_match = self.matcher.compare_subgraphs(ref_pb, trg_pb, self._ref_idx, self._trg_idx, regist_mode)
        self.area_matched = self.matcher.calc_area_matched(ref_pb, self.best_match)
        # >=3 matches are geometrically required (RegisterRGBD360.h:306); the
        # INI's min_planes_recognition can raise the bar further
        min_planes = max(3, self.matcher.config.min_planes_recognition)
        if len(self.best_match) < min_planes:
            return False
        ok, pose, info = estimate_pose_from_planes(ref_pb, trg_pb, self.best_match, regist_mode)
        if not ok:
            return False
        self.rigid_transf = pose
        self.information = info
        self.area_source = float(sum(ref_pb.planes[i].area_hull for i in self._ref_idx))
        self.area_target = float(sum(trg_pb.planes[j].area_hull for j in self._trg_idx))
        return True

    def register_dense_photoicp(self, frame1, frame2, pose_estim: Optional[np.ndarray] = None,
                                method: int = 0, n_levels: int = 4) -> bool:
        """Dense multi-sensor registration: one robot pose optimized jointly
        from the 8 cameras' pinhole residuals on the frames' device
        (reference RegisterRGBD360.h:344-516 RegisterDensePhotoICP;
        register_rgbd360.py:112), through the batched loop at B = 1
        (parallel/batch.py::align_batch_rig). frame2 is the source, its raw
        (not undistorted) depth in metres. Returns False when the system is
        ill-posed; sets the pose and, as information, the Hessian."""
        import torch

        from rgbd360_torch.ops.image import gray_f32
        from rgbd360_torch.parallel.batch import align_batch_rig

        dev = frame2.device
        guess = np.eye(4, dtype=np.float32) if pose_estim is None else pose_estim
        rt, _rt_inv, cam = frame1.calib.device_extrinsic_arrays(dev)  # cached uploads
        res = align_batch_rig(
            gray_f32(frame2.rgb)[None], (frame2.depth_raw_mm.to(torch.float32) * 0.001)[None],
            gray_f32(frame1.rgb)[None], (frame1.depth_raw_mm.to(torch.float32) * 0.001)[None],
            rt, cam, torch.as_tensor(guess, dtype=torch.float32).to(dev)[None], method=method, n_levels=n_levels,
        )
        self._done = True
        self.ref360, self.trg360 = frame1, frame2
        self.rigid_transf = res.pose[0].cpu().numpy()
        self.information = res.hessian[0].cpu().numpy()
        return not bool(res.ill_posed[0])

    # -- accessors ---------------------------------------------------------------
    def get_pose(self) -> np.ndarray:
        if not self._done:
            self.register_pbmap()
        return self.rigid_transf

    def get_info_mat(self) -> np.ndarray:
        if not self._done:
            self.register_pbmap()
        return self.information

    def get_cov_mat(self) -> np.ndarray:
        return np.linalg.pinv(self.get_info_mat().astype(np.float64)).astype(np.float32)

    def get_matched_planes(self) -> Dict[int, int]:
        if not self._done:
            self.register_pbmap()
        return self.best_match

    def get_area_matched(self) -> float:
        if not self._done:
            self.register_pbmap()
        return self.area_matched

    def calc_entropy(self) -> float:
        """Kerl IROS13 entropy of the plane-based estimate
        (reference RegisterRGBD360.h:230-239)."""
        cov = np.linalg.pinv(self.get_info_mat().astype(np.float64))
        sign, logdet = np.linalg.slogdet(cov)
        return float(0.5 * (6 * (1 + math.log(2 * math.pi)) + logdet))

    def tracking_score(self) -> int:
        """GOOD/WEAK/BAD by matched-area ratio (reference :526-540). A failed
        or never-run registration reports BAD: area_source is only set on
        success."""
        if self.area_source <= 0.0:
            return BAD
        score = self.get_area_matched() / self.area_source
        if score >= 0.7:
            return GOOD
        if score >= 0.3:
            return WEAK
        return BAD
