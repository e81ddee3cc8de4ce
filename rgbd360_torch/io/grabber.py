"""Copy of rgbd360_tpu/io/grabber.py (host numpy only: the port imports
nothing of the JAX package).

Acquisition layer — the reference's OpenNI2 grabber stack
(OpenNI2_Grabber/grabber/RGBDGrabber_OpenNI2.h:84-214 + Grabber/
RGBD360_Grabber.cpp) reduced to its testable core: a source abstraction that
produces RawFrame360 captures and a recorder that serializes them to the
reference .bin stream format.

No camera hardware exists in this deployment; sources are:
  * ReplaySource — re-reads an existing .bin sequence (regression/replay),
  * SyntheticSource — procedurally generated captures (CI without data).
A hardware OpenNI2 binding would implement the same Grabber interface.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from rgbd360_torch.io.boost_archive import RawFrame360, read_frame360_bin, write_frame360_bin


class Grabber:
    """Interface: init() -> grab() stream -> close(), plus the camera
    control surface of the reference's OpenNI2 grabber
    (RGBDGrabber_OpenNI2.h:84-214): setResolution mode 0=VGA/1=QVGA
    (:133-150, invalid modes keep the previous value), shutter in
    milliseconds (:153-171) and gain in percent, 100 = default (:173-189).
    Software sources store the values; a hardware binding would forward
    them to the camera stream."""

    VGA = 0  # 640x480 (RGBDGrabber_OpenNI2.h:137-140)
    QVGA = 1  # 320x240 (:141-145, the device default)

    def __init__(self) -> None:
        self.height, self.width = 240, 320
        self._shutter_ms = 10  # the reference ctor default exposure (:84)
        self._gain = 100

    def init(self) -> None:  # pragma: no cover - interface
        pass

    def set_resolution(self, mode: int) -> None:
        if mode == self.VGA:
            self.height, self.width = 480, 640
        elif mode == self.QVGA:
            self.height, self.width = 240, 320
        else:  # invalid mode: previous value left (:147-149)
            print("Error: grabber mode not valid! -> Previous value left")

    def set_shutter(self, exposure_ms: int) -> None:
        self._shutter_ms = int(exposure_ms)

    def get_shutter(self) -> int:
        return self._shutter_ms

    def set_gain(self, gain_percent: int) -> None:
        self._gain = int(gain_percent)

    def get_gain(self) -> int:
        return self._gain

    def grab(self) -> Optional[RawFrame360]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __iter__(self) -> Iterator[RawFrame360]:
        while True:
            frame = self.grab()
            if frame is None:
                return
            yield frame


class ReplaySource(Grabber):
    def __init__(self, dataset_dir: str, first: int = 1, sample: int = 1):
        super().__init__()
        self.dir = dataset_dir
        self.n = first
        self.sample = sample

    def grab(self) -> Optional[RawFrame360]:
        path = os.path.join(self.dir, f"sphere_images_{self.n}.bin")
        if not os.path.exists(path):
            return None
        self.n += self.sample
        return read_frame360_bin(path)


class SyntheticSource(Grabber):
    def __init__(self, num_frames: int = 3, seed: int = 0):
        super().__init__()
        self.remaining = num_frames
        # the seed shifts the texture phases so differently-seeded sources
        # genuinely differ (it was previously stored but unused)
        self.phase = float(np.random.default_rng(seed).uniform(0.0, 2.0 * np.pi))
        self.t = 0

    def grab(self) -> Optional[RawFrame360]:
        if self.remaining <= 0:
            return None
        self.remaining -= 1
        self.t += 1
        yy, xx = np.mgrid[0:240, 0:320]
        base = (
            128 + 60 * np.sin(xx / 17.0 + self.t * 0.2 + self.phase) * np.cos(yy / 13.0)
        ).astype(np.uint8)
        rgb = np.stack([np.stack([base, base // 2, 255 - base], axis=-1)] * 8)
        depth = np.stack(
            [
                (
                    2000 + 600 * np.sin(xx / 23.0 + s + self.phase) + 300 * np.cos(yy / 19.0)
                ).astype(np.uint16)
                for s in range(8)
            ]
        )
        return RawFrame360(rgb=rgb, depth=depth, timestamp=self.t)


class Recorder:
    """RGBD360_Grabber's record loop: stream -> sphere_images_%d.bin files
    (reference Grabber/RGBD360_Grabber.cpp:83+)."""

    def __init__(self, out_dir: str, first_index: int = 1):
        self.out_dir = out_dir
        self.index = first_index
        os.makedirs(out_dir, exist_ok=True)

    def record(self, source: Grabber, max_frames: Optional[int] = None) -> int:
        count = 0
        for frame in source:
            write_frame360_bin(
                os.path.join(self.out_dir, f"sphere_images_{self.index}.bin"), frame
            )
            self.index += 1
            count += 1
            if max_frames is not None and count >= max_frames:
                break
        return count
