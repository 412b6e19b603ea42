"""Entry-point scripts of the port, run as ``python -m
radar_tpu_torch.scripts.<name>``; each ports ``scripts/<name>.py``."""
