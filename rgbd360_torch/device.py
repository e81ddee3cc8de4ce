"""Device helpers of the port (no JAX counterpart: the JAX package takes
its backend from ``jax.default_backend()``).

The port never guesses a device: functions follow the device of their
input tensors. ``require_cuda`` is for entry points that only make sense
on the card (chip_smoke.py, timing) and must fail rather than fall back.
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """Return the first CUDA device; raise when no GPU is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry point needs an NVIDIA GPU")
    return torch.device("cuda", 0)
