"""Device helpers of the port (no JAX counterpart: the JAX package takes
its backend from ``jax.default_backend()``).

The port never guesses a device: functions follow the device of their
input tensors. Entry points (Frame360, RegisterPhotoICP, sequence_frames,
the apps) run on the card unless the caller names another device:
``resolve_device(None)`` is ``require_cuda()``, which fails rather than
fall back to the CPU.
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """Return the first CUDA device; raise when no GPU is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry point needs an NVIDIA GPU (pass device='cpu' to run on the CPU)")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA device; a CUDA device raises when there is no GPU."""
    if device is None or torch.device(device).type == "cuda":
        require_cuda()
    return torch.device("cuda", 0) if device is None else torch.device(device)
