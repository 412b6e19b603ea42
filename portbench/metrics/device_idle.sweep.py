"""device_idle.sweep: the share of the sweep's traced batches in which no
operation ran on the card (``torch.profiler``, the union of the device
operations' intervals within the traced span). Moves ``trials_per_s``."""

from portbench.harness import idle_percent as read  # noqa: F401
