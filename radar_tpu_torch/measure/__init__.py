"""Port of ``radar_tpu/measure/``."""
