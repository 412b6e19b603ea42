"""Port of ``radar_tpu/ops/``."""
