"""The CPU baseline frame — port of ``radar_tpu/bench/``."""
