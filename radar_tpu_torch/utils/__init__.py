"""Port of ``radar_tpu/utils/``."""
