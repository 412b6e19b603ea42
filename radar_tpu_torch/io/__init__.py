"""Port of ``radar_tpu/io/``: the checkpoint stores and the .bin record
reader and writer (``io/binio.py``)."""

from .checkpoint import (CheckpointStore, SaveOptions, load_sim_frame,
                         save_detection_log_json, save_sim_frame)
