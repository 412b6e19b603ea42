"""Port of ``radar_tpu/io/``: the checkpoint stores. ``binio`` (the .bin
real-data reader) is not ported yet."""

from .checkpoint import (CheckpointStore, SaveOptions, load_sim_frame,
                         save_detection_log_json, save_sim_frame)
