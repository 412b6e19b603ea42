"""MTD: the reference's windowed, fftshifted slow-time FFT
(fun_process_single_frame.m:129-136) — port of ``radar_tpu/ops/mtd.py:20-58``,
as the FFT (``mtd``) or folded into one constant [n_dop, pulses] matrix
product (``mtd_matmul``). ``fft_len`` zero-pads the transform (the v7_7
512-point variant, main_simulate_echoes_with_array_v7_7.m:150).
"""

from __future__ import annotations

import numpy as np
import torch


def mtd(pc: torch.Tensor, mtd_win, fft_len: int | None = None
        ) -> torch.Tensor:
    """[pulses, gates, beams] -> [fft_len or pulses, gates, beams] RDM:
    kaiser window, FFT over pulses, fftshift."""
    w = torch.as_tensor(np.asarray(mtd_win), device=pc.device).to(
        pc.real.dtype)
    y = torch.fft.fft(pc * w[:, None, None], n=fft_len, dim=0)
    return torch.fft.fftshift(y, dim=0)


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
