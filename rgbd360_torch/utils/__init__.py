"""Host utilities of the port: copies from rgbd360_tpu/utils."""
