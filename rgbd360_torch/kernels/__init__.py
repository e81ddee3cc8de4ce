"""Build and load of the CUDA kernels in rgbd360_torch/csrc/ (no JAX counterpart)."""
