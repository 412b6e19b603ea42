"""Port of ``radar_tpu/doa/``."""
