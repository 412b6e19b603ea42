"""Port of ``radar_tpu/pipeline/``."""
