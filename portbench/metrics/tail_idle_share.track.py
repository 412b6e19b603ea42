"""tail_idle_share.track: of the traced multi-frame runs' device-idle time
(the complement of the device operations' union, ``torch.profiler``), the
share during which the host was inside the frame tail's stages: the union
of the program's ``rt.cfar``, ``rt.extract``, ``rt.estimate``,
``rt.cluster1`` and ``rt.cluster2`` spans. Nothing without a CUDA trace.
Moves ``frames_per_s``."""

from portbench.spans import tail_idle_percent as read  # noqa: F401
