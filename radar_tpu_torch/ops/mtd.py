"""MTD: the reference's windowed, fftshifted slow-time FFT
(fun_process_single_frame.m:129-136) — port of ``radar_tpu/ops/mtd.py``,
as the FFT (``mtd``) or folded into one constant [n_dop, pulses] matrix
product (``mtd_matmul``). ``fft_len`` zero-pads the transform (the v7_7
512-point variant, main_simulate_echoes_with_array_v7_7.m:150).
``zero_velocity_suppress`` is the real-data path's DC clutter notch.
"""

from __future__ import annotations

import numpy as np
import torch


def mtd(pc: torch.Tensor, mtd_win, fft_len: int | None = None,
        dim: int = 0) -> torch.Tensor:
    """[pulses, gates, beams] -> [fft_len or pulses, gates, beams] RDM:
    kaiser window, FFT over pulses, fftshift. ``dim`` names the pulse axis
    of a batched cube (e.g. 1 for [slices, pulses, gates, beams])."""
    w = torch.as_tensor(np.asarray(mtd_win), device=pc.device).to(
        pc.real.dtype)
    w = w.reshape((-1,) + (1,) * (pc.ndim - 1 - dim))
    y = torch.fft.fft(pc * w, n=fft_len, dim=dim)
    return torch.fft.fftshift(y, dim=dim)


def make_mtd_matrix(mtd_win, num_pulses: int,
                    fft_len: int | None = None) -> np.ndarray:
    """Constant [n_dop, pulses] complex128 matrix M with the kaiser window,
    the DFT and the fftshift row order folded in:
    ``rdm = einsum('vp,pgb->vgb', M, pc)``."""
    n = fft_len or num_pulses
    p = np.arange(num_pulses)
    v = np.arange(n)
    dft = np.exp(-2j * np.pi * np.outer(v, p) / n)         # [n, P]
    m = dft * np.asarray(mtd_win)[None, :]
    return np.fft.fftshift(m, axes=0).astype(np.complex128)


def mtd_matmul(pc: torch.Tensor, mtd_matrix,
               precision: str = "f32") -> torch.Tensor:
    """[pulses, gates, beams] -> [n_dop, gates, beams] via the folded
    matrix; ``precision="bf16"`` uses bf16 operands, f32 accumulation."""
    m = torch.as_tensor(mtd_matrix, device=pc.device)
    if precision == "bf16":
        from .precision import einsum_complex_bf16

        return einsum_complex_bf16("vp,pgb->vgb", m, pc, out_dtype=pc.dtype)
    return torch.einsum("vp,pgb->vgb", m.to(pc.dtype), pc)


def zero_velocity_suppress(rdm: torch.Tensor, velocity_axis,
                           v_half_width_ms: float) -> torch.Tensor:
    """Zero the Doppler bins within +/- v_half_width_ms of zero velocity —
    the real-data path's DC clutter suppression (``fun_0v_pressing``,
    inline copy at debug_simulated_data_processing_v2.m:259-405; half-width
    from ``config.mtd.MTD_V=3 m/s``)."""
    mask = torch.as_tensor(velocity_axis, device=rdm.device).abs() \
        <= v_half_width_ms
    return torch.where(mask[:, None, None], torch.zeros((), dtype=rdm.dtype,
                                                        device=rdm.device),
                       rdm)
