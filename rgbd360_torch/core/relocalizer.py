"""Relocalizer360 — relocalization against the map's keyframes
(reference include/Relocalizer360.h:78-93): accept at >=5 matched planes with
matched area > 10, scanning newest-first.

Counterpart of rgbd360_tpu/core/relocalizer.py. The reference brute-forces
a sequential PbMap registration per keyframe; here, as in JAX, every
keyframe's unary plane-compatibility upper bound is evaluated in one batched
call on the device (core/batch_match.py — a strict relaxation, so the
accepted keyframe is identical) and the exact interpretation-tree
registration runs on the host only on survivors, newest-first. The
prefilter runs on ``device``, the card unless the caller names another.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from rgbd360_torch.core.batch_match import prefilter_candidates
from rgbd360_torch.core.map360 import Map360
from rgbd360_torch.core.matcher import PLANAR_3DOF
from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360
from rgbd360_torch.device import resolve_device

MIN_MATCHES = 5
MIN_AREA = 10.0


class Relocalizer360:
    def __init__(self, map360: Map360, config_file: Optional[str] = None, device=None):
        self.map = map360
        self.registerer = RegisterRGBD360(config_file)
        self.device = resolve_device(device)
        self.reloc_kf: int = -1

    def _survivors(self, frame):
        """Newest-first keyframe ids whose batched compatibility upper bound
        clears the acceptance gates."""
        if frame.planes is None:
            return []  # nothing to match against (get_planes not called)
        # keyframes without plane data cannot be PbMap-registered at all:
        # they are skipped, not blindly returned
        kf_ids = [k for k in range(len(self.map.frames)) if self.map.frames[k].planes is not None]
        if not kf_ids:
            return []
        pbmaps = [self.map.frames[k].planes for k in kf_ids]
        counts, areas = prefilter_candidates(
            frame.planes, pbmaps, self.registerer.matcher.config, PLANAR_3DOF, device=self.device
        )
        return [
            k for i, k in reversed(list(enumerate(kf_ids)))
            if counts[i] >= MIN_MATCHES and areas[i] > MIN_AREA
        ]

    def relocalize(self, frame) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        """Returns (keyframe_id, relative_pose, information 6x6) or None —
        the information matrix lets the caller add a properly weighted graph
        edge (the reference stores informationM, Relocalizer360.h:90)."""
        for kf_id in self._survivors(frame):
            ok = self.registerer.register_pbmap(self.map.frames[kf_id], frame, 25, PLANAR_3DOF)
            if (
                ok
                and len(self.registerer.get_matched_planes()) >= MIN_MATCHES
                and self.registerer.get_area_matched() > MIN_AREA
            ):
                self.reloc_kf = kf_id
                return kf_id, self.registerer.get_pose(), self.registerer.get_info_mat()
        return None
