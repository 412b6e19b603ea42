"""Port of ``radar_tpu/cluster/``."""
