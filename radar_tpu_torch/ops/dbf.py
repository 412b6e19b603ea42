"""DBF weight conventions — port of ``radar_tpu/ops/dbf.py:21``.

  - "v8":       y = x @ W^H            (fun_process_single_frame.m:95)
  - "v7_7":     y = x @ fliplr(W).T    (main_simulate_echoes_with_array_v7_7.m:341)
  - "realdata": y = x @ W.T            (main_test_with_simulated_data.m:210-214)
"""

from __future__ import annotations

import numpy as np


def dbf_weights_effective_np(w, variant: str = "v8") -> np.ndarray:
    """Effective host-numpy weights M [beams, channels] such that
    ``y = einsum('...c,bc->...b', x, M)`` reproduces ``variant``."""
    w = np.asarray(w)
    if variant == "v8":
        return np.conj(w)
    if variant == "v7_7":
        return np.flip(w, axis=1)
    if variant == "realdata":
        return w
    raise ValueError(f"unknown DBF variant: {variant}")
