"""Tensor functions of the dense aligner (counterpart of rgbd360_tpu/ops/)."""
