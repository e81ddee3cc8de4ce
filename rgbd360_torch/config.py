"""Global configuration of the port: a copy of rgbd360_tpu/config.py.

One typed config system covering the four configuration sources of the
reference (see SURVEY.md §5 "Config / flag system"):
  * global tunables       (reference include/Miscellaneous.h:51-76)
  * compile-time #defines (reference include/Frame360.h:40-41)
  * per-app argv defaults (reference Registration/*.cpp)
  * matcher INI files     (reference config_files/*.ini) -> io/ini.py
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GlobalParams:
    """Global tunables (reference include/Miscellaneous.h:51-76)."""

    # Maximum number of planes to match when registering a pair of spheres
    max_match_planes: int = 25
    # Maximum curvature to consider a region planar
    max_curvature_plane: float = 0.0013
    # Minimum convex-hull area to keep a planar patch (m^2)
    min_area_plane: float = 0.12
    # Maximum elongation to keep a planar patch
    max_elongation_plane: float = 6.0
    # Minimum number of matched planes for a good registration
    min_planes_registration: int = 4
    # Minimum distance between keyframes (m)
    min_dist_keyframes: float = 0.2
    # Odometry motion bounds between consecutive frames
    max_translation_odometry: float = 1.8
    max_rotation_odometry: float = 1.2
    # Max eigenvalue ratio to accept a calibration system
    threshold_conditioning: float = 8000.0


@dataclasses.dataclass(frozen=True)
class FrameParams:
    """Frame-assembly switches (reference include/Frame360.h:40-41 defines)."""

    use_bilateral_filter: bool = True
    downsample_160: bool = True  # DOWNSAMPLE_160: 320x240 clouds -> 160x120
    num_sensors: int = 8
    sensor_width: int = 320
    sensor_height: int = 240
    # Spherical panorama: width = num_sensors * sensor rows; height keeps the
    # 60 deg band (reference include/Frame360.h:391-394). Derived properties
    # so a changed rig geometry cannot leave stale literals behind.
    # API note (round-2 change): these were dataclass fields before;
    # FrameParams(sphere_width=...) / dataclasses.replace(sphere_width=...)
    # now raise TypeError and fields()/asdict() omit them. Panorama dims are
    # always derived — set num_sensors/sensor_height to change them.
    @property
    def sphere_width(self) -> int:
        return self.num_sensors * self.sensor_height

    @property
    def sphere_height(self) -> int:
        return int(self.sphere_width * 0.5 * 60.0 / 180.0)


@dataclasses.dataclass(frozen=True)
class RegistrationParams:
    """Dense registration defaults (reference include/RegisterPhotoICP.h:201-221)."""

    min_depth: float = 0.3
    max_depth: float = 6.0
    n_pyr_levels: int = 4
    std_dev_photo: float = 6.0 / 255.0
    std_dev_depth: float = 0.2
    thres_saliency_intensity: float = 0.01
    thres_saliency_depth: float = 0.01
    max_iters: int = 10
    # alignFrames360 tolerances (reference include/RegisterPhotoICP.h:4593-4595)
    tol_update: float = 1e-4
    tol_residual_sphere: float = 1e-3
    tol_residual_pinhole: float = 1e-4


default_params = GlobalParams()
default_frame_params = FrameParams()
default_registration_params = RegistrationParams()
