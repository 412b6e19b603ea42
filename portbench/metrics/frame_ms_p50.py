"""frame_ms_p50: the median of the window's frame latencies (one
processor call to the next; a run's last frame to ``run_multiframe``'s
return), outside the profiled runs; the steadier statistic beside
``frame_ms_p95``. Moves ``frames_per_s``."""

import numpy as np


def read(run):
    lat = run.state.get("frame_ms")
    return float(np.median(lat)) if lat else None
