"""Port of ``radar_tpu/waveform/``."""
