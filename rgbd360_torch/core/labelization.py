"""Plane labelization — semantic annotation of planar patches and label
propagation along a registered sequence (reference Labelization/
LabelizeFrame360.cpp:40+ manual annotation, LabelizeSequence.cpp:40+
propagation via plane matching).

A copy of rgbd360_tpu/core/labelization.py over the port's PbMap
registration (host numpy).
"""

from __future__ import annotations

from typing import Dict, Optional

from rgbd360_torch.core.matcher import PLANAR_ODOMETRY_3DOF
from rgbd360_torch.core.register_rgbd360 import RegisterRGBD360


def labelize_frame(frame, labels: Dict[int, str]) -> int:
    """Assign labels to planes by id (the interactive annotation of
    LabelizeFrame360 becomes an explicit mapping). Returns #labeled."""
    count = 0
    for plane in frame.planes.planes:
        if plane.id in labels:
            plane.label = labels[plane.id]
            count += 1
    return count


def propagate_labels(
    ref_frame,
    new_frame,
    registerer: Optional[RegisterRGBD360] = None,
    regist_mode: int = PLANAR_ODOMETRY_3DOF,
) -> int:
    """Propagate labels from a labeled frame to a new frame through PbMap
    plane matching (LabelizeSequence.cpp:96: PLANAR_ODOMETRY_3DoF with
    MAX_MATCH_PLANES=30, :73). Labeled planes are force-included in the
    match subgraphs (RegisterRGBD360.h:128-131). Returns #propagated."""
    registerer = registerer or RegisterRGBD360()
    if not registerer.register_pbmap(ref_frame, new_frame, 30, regist_mode):
        return 0
    count = 0
    for ref_id, trg_id in registerer.get_matched_planes().items():
        label = ref_frame.planes.planes[ref_id].label
        if label:
            new_frame.planes.planes[trg_id].label = label
            count += 1
    return count
