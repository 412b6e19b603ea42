"""device_idle.track: the share of the traced multi-frame runs in which no
operation ran on the card (``torch.profiler``, the union of the device
operations' intervals within the traced span). Moves ``frames_per_s``."""

from portbench.harness import idle_percent as read  # noqa: F401
