"""Kalibr-compatible AprilGrid charts: ``generator`` draws them (SVG, PNG,
vector PDF, JSON config); ``python -m aprilgrid_tpu_torch.boards`` is the
command line."""
