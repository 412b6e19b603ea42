"""Digital beamforming — port of ``radar_tpu/ops/dbf.py:21-54``: one
complex contraction over the channel axis of the whole [pulses, samples,
channels] cube (the reference's per-pulse ``x * DBF_coeffs'``,
fun_process_single_frame.m:93-97). A plain complex product, left to
``torch.einsum`` as the JAX code leaves it to XLA. Conventions:

  - "v8":       y = x @ W^H            (fun_process_single_frame.m:95)
  - "v7_7":     y = x @ fliplr(W).T    (main_simulate_echoes_with_array_v7_7.m:341)
  - "realdata": y = x @ W.T            (main_test_with_simulated_data.m:210-214)
"""

from __future__ import annotations

import numpy as np
import torch


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


def dbf(raw_iq: torch.Tensor, w, variant: str = "v8") -> torch.Tensor:
    """[pulses, samples, channels] x host weights [beams, channels] ->
    [pulses, samples, beams]."""
    m = torch.as_tensor(
        np.ascontiguousarray(dbf_weights_effective_np(w, variant)),
        device=raw_iq.device)
    return torch.einsum("psc,bc->psb", raw_iq, m.to(raw_iq.dtype))
