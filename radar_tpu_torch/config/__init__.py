"""Port of ``radar_tpu/config/``."""
