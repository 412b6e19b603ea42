"""Port of ``radar_tpu/sim/``."""
