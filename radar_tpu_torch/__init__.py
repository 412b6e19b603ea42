"""radar_tpu_torch — the PyTorch/CUDA port of ``radar_tpu``.

Module paths mirror the JAX package (``radar_tpu_torch/ops/cfar.py`` ports
``radar_tpu/ops/cfar.py``), and ``radar_tpu`` stays the reference each
module is tested against. The port imports ``torch`` and never ``jax`` or
``radar_tpu``; host-side constants it needs are carried as its own copies.
Hand-written CUDA kernels live in ``csrc/`` and are compiled on first use
by ``_build.py``.
"""

from .config.params import (PERF_OVERRIDES, RadarConfig, full_config,
                            perf_config, small_test_config)

__version__ = "0.1.0"
