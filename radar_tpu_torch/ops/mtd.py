"""MTD as one constant-matrix product — port of ``radar_tpu/ops/mtd.py:29-58``
(the reference's windowed, fftshifted slow-time FFT,
fun_process_single_frame.m:129-136, folded into a [n_dop, pulses] matrix).
"""

from __future__ import annotations

import numpy as np
import torch


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
