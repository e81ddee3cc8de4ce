"""CLI apps of the port (python -m rgbd360_torch.apps.<app>)."""
