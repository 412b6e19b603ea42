"""The plain reference of the benchmark: plain PyTorch and NumPy,
with nothing of the measured program."""
