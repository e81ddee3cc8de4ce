"""RegisterPhotoICP — object facade over the dense spherical aligner.

Counterpart of rgbd360_tpu/core/register_photoicp.py, mirroring the
reference public API (include/RegisterPhotoICP.h:480-4800: setSourceFrame,
setTargetFrame, alignFrames360, getOptimalPose, getHessian, getGradient,
calcEntropy, SSO, avPhotoResidual, avDepthResidual). Same defaults as the
JAX facade: 4 pyramid levels, PHOTO_CONSISTENCY, an 8-entry LRU pyramid
cache keyed by array identity (register_photoicp.py:22-66).

Frames are (H, W, 3) u8 BGR plus (H, W) depth, u16 millimetres or f32
metres, as torch tensors or numpy arrays. Tensors stay on their device;
numpy arrays go to the facade's ``device`` (the card unless given). The
facade runs one pair (the port's ops carry a pair axis of size 1 here).

Not ported: ``prewarm`` (a compile warm-up of the JAX package; it comes
with the SLAM slice, which is its only caller) and the async host copy of
the packed result (``copy_to_host_async``): the facade packs every
host-read output into one flat tensor and reads it with one ``.cpu()``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rgbd360_torch.device import resolve_device
from rgbd360_torch.ops import photoicp
from rgbd360_torch.utils.timing import stage

PHOTO_CONSISTENCY = photoicp.PHOTO_CONSISTENCY
DEPTH_CONSISTENCY = photoicp.DEPTH_CONSISTENCY
PHOTO_DEPTH = photoicp.PHOTO_DEPTH


def _pack_result(res: photoicp.AlignResult) -> torch.Tensor:
    """Every host-read output of pair 0 as one flat f32 vector: [pose 16,
    hessian 36, gradient 6, error, av_photo, av_depth, sso, ill_posed,
    num_iterations (n_levels)] (register_photoicp.py:164 reads this layout)."""
    scalars = torch.stack(
        [res.error[0], res.av_photo_residual[0], res.av_depth_residual[0], res.sso[0],
         res.ill_posed[0].to(torch.float32)]
    )
    return torch.cat(
        [res.pose[0].reshape(-1), res.hessian[0].reshape(-1), res.gradient[0].reshape(-1),
         scalars, res.num_iterations[0].to(torch.float32)]
    )


class RegisterPhotoICP:
    _PYR_CACHE_SIZE = 8

    def __init__(self, n_pyr_levels: int = 4, device=None):
        self.n_pyr_levels = n_pyr_levels
        self.device = resolve_device(device)
        self.min_depth = photoicp.MIN_DEPTH
        self.max_depth = photoicp.MAX_DEPTH
        self._src = None
        self._trg = None
        self._result: Optional[photoicp.AlignResult] = None
        self._flat: Optional[torch.Tensor] = None
        self._host: Optional[dict] = None
        self._pyr_cache = []  # [(rgb, depth, is_target, n_levels, pyramids)], LRU last

    # -- reference API --------------------------------------------------------
    def set_num_pyr(self, n: int) -> None:
        self.n_pyr_levels = n
        self._src = self._trg = None

    def _as_tensor(self, x) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=self.device)

    def _pyramids(self, rgb_bgr_u8, depth, is_target: bool):
        for i, entry in enumerate(self._pyr_cache):
            if entry[0] is rgb_bgr_u8 and entry[1] is depth and entry[2] == is_target and entry[3] == self.n_pyr_levels:
                # LRU: the tracked keyframe's target entry stays hot
                self._pyr_cache.append(self._pyr_cache.pop(i))
                return entry[4]
        rgb = self._as_tensor(rgb_bgr_u8)
        dep = self._as_tensor(depth).to(rgb.device)
        pyr = photoicp.build_pyramid_set_raw(
            rgb[None], dep[None], self.n_pyr_levels, is_target=is_target, sphere_seam_mask=True,
        )
        self._pyr_cache.append((rgb_bgr_u8, depth, is_target, self.n_pyr_levels, pyr))
        if len(self._pyr_cache) > self._PYR_CACHE_SIZE:
            self._pyr_cache.pop(0)
        return pyr

    def set_source_frame(self, rgb_bgr_u8, depth) -> None:
        """Contract: the arrays must not be mutated in place after this
        call; pyramids are cached by array identity (``is``)."""
        self._src = self._pyramids(rgb_bgr_u8, depth, is_target=False)

    def set_target_frame(self, rgb_bgr_u8, depth) -> None:
        """Same no-in-place-mutation contract as set_source_frame."""
        self._trg = self._pyramids(rgb_bgr_u8, depth, is_target=True)

    def align_frames360(
        self,
        pose_guess=None,
        method: int = PHOTO_CONSISTENCY,
        occlusion: int = 0,
        full_coverage: bool = False,
    ) -> np.ndarray:
        """occlusion: 0 plain, 1 z-buffered (Occ1), 2 + dynamic occlusion
        (Occ2), as the reference parameter (RegisterPhotoICP.h:4519).
        full_coverage: the triple-anchored gather in every sweep (loop-
        closure refinement, relocalization verify). Returns the pose.
        Timed as the stage "Dense alignment 360" (utils/timing.py), up to
        the host copy of the result."""
        with stage("Dense alignment 360", sync=lambda: self._fetch() if self._flat is not None else None):
            self.dispatch_frames360(pose_guess, method, occlusion=occlusion, full_coverage=full_coverage)
        return self.get_optimal_pose()

    def dispatch_frames360(
        self,
        pose_guess=None,
        method: int = PHOTO_CONSISTENCY,
        occlusion: int = 0,
        full_coverage: bool = False,
    ) -> None:
        """align_frames360 without reading the result back; the accessors
        read it on first use."""
        if self._src is None or self._trg is None:
            raise RuntimeError("set the source and target frames first")
        dev = self._src[0][0].device
        guess = np.eye(4) if pose_guess is None else pose_guess
        guess = torch.as_tensor(guess, dtype=torch.float32).to(dev).reshape(1, 4, 4)
        self._result = photoicp.align_frames360(
            self._src, self._trg, guess, method, occlusion=occlusion, full_coverage=full_coverage,
        )
        self._flat = _pack_result(self._result)
        self._host = None

    # -- accessors -------------------------------------------------------------
    @property
    def result(self) -> photoicp.AlignResult:
        if self._result is None:
            raise RuntimeError("align first")
        return self._result

    def _fetch(self) -> dict:
        if self._flat is None:
            raise RuntimeError("align first")
        if self._host is None:
            flat = self._flat.cpu().numpy()
            self._host = {
                "pose": flat[0:16].reshape(4, 4).copy(),
                "hessian": flat[16:52].reshape(6, 6).copy(),
                "gradient": flat[52:58].copy(),
                "error": float(flat[58]),
                "av_photo": float(flat[59]),
                "av_depth": float(flat[60]),
                "sso": float(flat[61]),
                "ill": bool(flat[62] != 0.0),
                "iters": flat[63:].astype(np.int32),
            }
        return self._host

    def get_optimal_pose(self) -> np.ndarray:
        return self._fetch()["pose"]

    def get_hessian(self) -> np.ndarray:
        return self._fetch()["hessian"]

    def get_gradient(self) -> np.ndarray:
        return self._fetch()["gradient"]

    def calc_entropy(self) -> float:
        """Kerl-IROS13 pose entropy (reference RegisterPhotoICP.h:4789-4797)
        from the host copy of the Hessian, in f64 (register_photoicp.py:221)."""
        sign, logdet = np.linalg.slogdet(self._fetch()["hessian"].astype(np.float64))
        logdet = logdet if sign > 0 else -np.inf
        return float(0.5 * (6.0 * (1.0 + np.log(2.0 * np.pi)) - logdet))

    @property
    def sso(self) -> float:
        return self._fetch()["sso"]

    @property
    def av_photo_residual(self) -> float:
        return self._fetch()["av_photo"]

    @property
    def av_depth_residual(self) -> float:
        return self._fetch()["av_depth"]

    @property
    def ill_posed(self) -> bool:
        return self._fetch()["ill"]

    @property
    def num_iterations(self) -> np.ndarray:
        return self._fetch()["iters"]
