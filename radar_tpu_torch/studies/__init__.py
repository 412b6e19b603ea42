"""Port of ``radar_tpu/studies/``: study kernels that lost their integrated
A/B on the TPU and are kept as recorded evidence, outside ``ops/`` so the
frame has no unwired production-lookalike paths."""
