"""Object facades (counterpart of rgbd360_tpu/core/)."""
