"""Batched pair registration (counterpart of rgbd360_tpu/parallel/)."""
