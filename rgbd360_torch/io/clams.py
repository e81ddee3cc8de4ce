"""Parser for CLAMS discrete depth-distortion model binaries.

File format (reference OpenNI2_Grabber/third_party/CLAMS/
discrete_depth_distortion_model.cpp:242-281 and eigen_extensions.h:85-95):

  "DiscreteDepthDistortionModel v01\n"
  scalar i32 width, i32 height, i32 bin_width, i32 bin_height,
         f64 bin_depth, i32 num_bins_x, i32 num_bins_y
  then num_bins_y*num_bins_x frustums, row-major, each:
      f64 max_dist, i32 num_bins, f64 bin_depth
      4x eigen vector: i32 sizeof(elem)=4, i32 rows, i32 cols,
         rows*cols f32   (counts, total_numerators, total_denominators,
                          multipliers)

The runtime correction (DiscreteFrustum::interpolatedUndistort, cpp:49-70):
for measured depth z, pick the spatial bin (u/bin_width, v/bin_height) and the
two depth bins bracketing z; multiply z by the linearly-interpolated
multiplier, falling back to the nearest bin's multiplier when either depth bin
has fewer than 50 training counts or z lies in the first/last half-bin.

Instead of a per-pixel object tree, everything is flattened into dense
arrays so the whole 8-sensor undistort is one batched pass
(ops/undistort.py). A copy of rgbd360_tpu/io/clams.py.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from rgbd360_torch.io.boost_archive import _Cursor as _BaseCursor

MAGIC = b"DiscreteDepthDistortionModel v01\n"


class _Cursor(_BaseCursor):
    """The shared byte cursor plus the Eigen-matrix record CLAMS serializes
    (eigen_extensions: i32 elem bytes, rows, cols, raw f32 data)."""

    def eigen_vec(self) -> np.ndarray:
        nbytes, rows, cols = self.unpack("iii")
        assert nbytes == 4, f"expected f32 eigen vector, got elem size {nbytes}"
        return np.frombuffer(self.take(4 * rows * cols), np.float32).copy()


@dataclasses.dataclass
class DepthDistortionModel:
    """Dense-array form of one sensor's CLAMS model.

    multipliers: (num_bins_y, num_bins_x, num_depth_bins) f32
    counts:      (num_bins_y, num_bins_x, num_depth_bins) f32
    """

    width: int
    height: int
    bin_width: int
    bin_height: int
    bin_depth: float
    multipliers: np.ndarray
    counts: np.ndarray

    @property
    def num_depth_bins(self) -> int:
        return self.multipliers.shape[-1]

    def downsample_params(self, step: int) -> "DepthDistortionModel":
        """Halve the pixel geometry only; the frustum grid is unchanged
        (reference discrete_depth_distortion_model.cpp:313-320)."""
        assert self.bin_width % step == 0 and self.bin_height % step == 0
        return dataclasses.replace(
            self,
            width=self.width // step,
            height=self.height // step,
            bin_width=self.bin_width // step,
            bin_height=self.bin_height // step,
        )


def load_clams_model(path: str) -> DepthDistortionModel:
    with open(path, "rb") as f:
        cur = _Cursor(f.read())

    if cur.take(len(MAGIC)) != MAGIC:
        raise ValueError(f"{path}: not a CLAMS v01 model")
    width, height, bin_width, bin_height = cur.unpack("iiii")
    (bin_depth,) = cur.unpack("d")
    num_bins_x, num_bins_y = cur.unpack("ii")

    n_depth = None
    mults = np.zeros((num_bins_y, num_bins_x, 0), np.float32)
    counts = np.zeros((num_bins_y, num_bins_x, 0), np.float32)
    for y in range(num_bins_y):
        for x in range(num_bins_x):
            (_max_dist,) = cur.unpack("d")
            (f_bins,) = cur.unpack("i")
            (f_bin_depth,) = cur.unpack("d")
            assert abs(f_bin_depth - bin_depth) < 1e-9
            c = cur.eigen_vec()
            _num = cur.eigen_vec()
            _den = cur.eigen_vec()
            m = cur.eigen_vec()
            if n_depth is None:
                n_depth = f_bins
                mults = np.ones((num_bins_y, num_bins_x, n_depth), np.float32)
                counts = np.zeros((num_bins_y, num_bins_x, n_depth), np.float32)
            mults[y, x] = m
            counts[y, x] = c

    return DepthDistortionModel(
        width=width,
        height=height,
        bin_width=bin_width,
        bin_height=bin_height,
        bin_depth=float(bin_depth),
        multipliers=mults,
        counts=counts,
    )
