"""rgbd360_torch — the PyTorch + CUDA port of rgbd360_tpu.

Counterpart of ``rgbd360_tpu/__init__.py`` without its persistent compile
cache (PyTorch runs eagerly; the CUDA kernels build once per checkout, see
``kernels/build.py``). The port never imports jax or rgbd360_tpu; the JAX
package stays the reference it is tested against (tests/test_torch_*.py).

Layout mirrors the JAX package:
  ops/       tensor functions of the dense aligner (se3, linalg6, image,
             sphere, warp_gather, photoicp)
  core/      the RegisterPhotoICP facade
  parallel/  batched pair registration (align_batch)
  csrc/      hand-written CUDA kernels for Hopper (sm_90a)
  kernels/   nvcc build + ctypes loader of csrc/
  convert.py numpy (JAX-package state) <-> port tensors

Precision is set here, once, for the whole package: the 6x6 normal
equations and the pose chain need full f32 (the lesson of ``_mm`` at
rgbd360_tpu/ops/photoicp.py:135-140), so TF32 is off for matmuls and
convolutions.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
