"""Calibration container for the 8-sensor omnidirectional rig.

Counterpart of rgbd360_tpu/io/calib.py, mirroring the reference Calib360
(include/Calib360.h): per-sensor CLAMS intrinsic depth-distortion models and
extrinsic 4x4 poses, plus the shared QVGA pinhole camera matrix. The arrays
are numpy on the host; the device copies are torch tensors made once per
device and cached (JAX :55-90), as is anything else a caller derives from
the calibration alone (``cached``: the stitch maps of ops/stitch.py).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from rgbd360_torch.io.clams import DepthDistortionModel, load_clams_model

NUM_SENSORS = 8


def qvga_camera_matrix() -> np.ndarray:
    """Pinhole intrinsics at QVGA (reference include/Calib360.h:74-77)."""
    return np.array(
        [[262.5, 0.0, 159.5], [0.0, 262.5, 119.5], [0.0, 0.0, 1.0]], np.float32
    )


class Calib360:
    def __init__(self) -> None:
        self.camera_matrix = qvga_camera_matrix()
        self.Rt = np.tile(np.eye(4, dtype=np.float32), (NUM_SENSORS, 1, 1))
        self.Rt_inv = np.tile(np.eye(4, dtype=np.float32), (NUM_SENSORS, 1, 1))
        self.intrinsic_model: List[Optional[DepthDistortionModel]] = [None] * NUM_SENSORS
        self._device_cache = {}

    # -- loading ------------------------------------------------------------
    def load_extrinsic_calibration(self, path: str) -> None:
        """Load Rt_01.txt..Rt_08.txt (reference include/Calib360.h:122-131)."""
        for sensor_id in range(NUM_SENSORS):
            fname = os.path.join(path, f"Rt_0{sensor_id + 1}.txt")
            self.Rt[sensor_id] = np.loadtxt(fname, dtype=np.float64).astype(np.float32)
            self.Rt_inv[sensor_id] = np.linalg.inv(
                self.Rt[sensor_id].astype(np.float64)
            ).astype(np.float32)
        self._device_cache.clear()

    def load_intrinsic_calibration(self, path: str, downsample: int = 2) -> None:
        """Load distortion_model1..8 and downsample to QVGA
        (reference include/Calib360.h:104-119)."""
        for sensor_id in range(NUM_SENSORS):
            model = load_clams_model(os.path.join(path, f"distortion_model{sensor_id + 1}"))
            self.intrinsic_model[sensor_id] = model.downsample_params(downsample)
        self._device_cache.clear()

    # -- cached device copies ------------------------------------------------
    # The calibration is constant across a run. Mutating Rt/Rt_inv/
    # intrinsic_model in place after first device use is not supported; the
    # load_* methods invalidate the cache.
    def cached(self, key, make):
        """The value of ``make()`` under ``key`` (which names the device),
        computed once per calibration load."""
        if key not in self._device_cache:
            self._device_cache[key] = make()
        return self._device_cache[key]

    def device_intrinsic_arrays(self, device):
        """(multipliers, counts) as f32 tensors on ``device`` + the shared
        geometry (a DepthDistortionModel)."""

        def make():
            mults, counts, geom = self.stacked_intrinsic_arrays()
            return torch.from_numpy(mults).to(device), torch.from_numpy(counts).to(device), geom

        return self.cached(("intrinsics", str(torch.device(device))), make)

    def device_extrinsic_arrays(self, device):
        """(Rt, Rt_inv, camera_matrix) as f32 tensors on ``device``."""

        def make():
            return tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (self.Rt, self.Rt_inv, self.camera_matrix)
            )

        return self.cached(("extrinsics", str(torch.device(device))), make)

    @classmethod
    def load(
        cls,
        root: str,
        with_intrinsics: bool = True,
        with_extrinsics: bool = True,
    ) -> "Calib360":
        """Load from a reference-layout data root (Calibration/{Intrinsics,Extrinsics})."""
        calib = cls()
        if with_extrinsics:
            calib.load_extrinsic_calibration(os.path.join(root, "Calibration", "Extrinsics"))
        if with_intrinsics:
            calib.load_intrinsic_calibration(os.path.join(root, "Calibration", "Intrinsics"))
        return calib

    # -- batched views for device kernels -----------------------------------
    def stacked_intrinsic_arrays(self):
        """Return (multipliers, counts) stacked over sensors:
        (8, num_bins_y, num_bins_x, n_depth) each, plus the shared geometry."""
        models = [m for m in self.intrinsic_model if m is not None]
        assert len(models) == NUM_SENSORS, "intrinsic models not loaded"
        for m in models[1:]:
            # the batched undistort applies models[0]'s binning to all
            # sensors — mixed geometries would be silently wrong
            assert (m.bin_width, m.bin_height, m.bin_depth) == (
                models[0].bin_width, models[0].bin_height, models[0].bin_depth,
            ), "distortion models disagree on bin geometry"
        mults = np.stack([m.multipliers for m in models])
        counts = np.stack([m.counts for m in models])
        return mults, counts, models[0]
