"""Copy of rgbd360_tpu/core/map360.py (numpy only). Keyframes keep their
device tensors (the panoramas on the frames' device); poses are numpy.

Map360 — the keyframe pose-graph map (reference include/Map360.h:43-97).

Host-side structure-of-lists with a lock guarding mutation (the reference's
boost::mutex mapMutex); device work happens in the registration ops, not here.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


class Map360:
    def __init__(self) -> None:
        # keyframes (vpSpheres) and their poses
        self.frames: List[object] = []
        self.trajectory_poses: List[np.ndarray] = []
        self.optimized_poses: List[np.ndarray] = []
        self.trajectory_increments: List[float] = []  # accumulated path length
        # kf -> {other_kf: (relative_pose 4x4, information 6x6)}
        self.connection_kfs: Dict[int, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
        # topological areas
        self.areas: List[Set[int]] = []
        self.neighbor_areas: List[Set[int]] = []
        self.selected_kfs: List[int] = []
        self.current_area: int = 0
        self.mutex = threading.RLock()

    def __len__(self) -> int:
        return len(self.frames)

    def add_keyframe(self, frame, pose: np.ndarray) -> int:
        """Append a keyframe to the current area (reference Map360.h:90-97)."""
        with self.mutex:
            kf_id = len(self.frames)
            frame.id = kf_id
            frame.node = self.current_area
            frame.pose = np.asarray(pose, np.float32)
            self.frames.append(frame)
            self.trajectory_poses.append(np.asarray(pose, np.float32))
            if not self.areas:
                self.areas.append(set())
                self.neighbor_areas.append({0})
                self.selected_kfs.append(0)
            if kf_id == 0:
                self.trajectory_increments.append(0.0)
            else:
                step = float(
                    np.linalg.norm(
                        pose[:3, 3] - self.trajectory_poses[kf_id - 1][:3, 3]
                    )
                )
                self.trajectory_increments.append(
                    self.trajectory_increments[-1] + step
                )
            self.areas[self.current_area].add(kf_id)
            self.connection_kfs.setdefault(kf_id, {})
            return kf_id

    def add_connection(
        self, kf1: int, kf2: int, rel_pose: np.ndarray, information: np.ndarray
    ) -> None:
        """Store the connection (older, newer) with rel_pose expressed as the
        newer keyframe's pose in the older's frame — the orientation
        map_io.load_map replays into optimizer.add_edge(older, newer, rel).
        The key normalization below does NOT flip rel_pose, so a reversed
        call order would silently store the inverse constraint."""
        assert kf1 < kf2, "pass (older, newer); rel = newer pose in older's frame"
        with self.mutex:
            self.connection_kfs.setdefault(kf2, {})[kf1] = (
                np.asarray(rel_pose, np.float32),
                np.asarray(information, np.float32),
            )

    def local_index(self, kf_id: int) -> int:
        """Ordinal of a keyframe inside its area (sorted-set distance)."""
        area = self.frames[kf_id].node
        return sorted(self.areas[area]).index(kf_id)
