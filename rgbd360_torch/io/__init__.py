"""Host I/O of the port: copies of rgbd360_tpu/io (numpy only, no jax)."""
