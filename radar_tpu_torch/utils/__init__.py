"""Port of ``radar_tpu/utils/``."""
from .profiling import FrameMetrics, MetricsLog, StageTimer, trace
