"""Complex contraction with bf16 operands and f32 accumulation — port of
``radar_tpu/ops/precision.py`` (``matmul_precision="bf16"``).

Each real/imaginary operand plane is rounded to bf16 and widened back to
f32 before an f32 einsum: the products of two bf16 values are exact in
f32, so this is bf16-operand / f32-accumulate arithmetic on every device
(on the card the f32 matmul runs without TF32). Real operands skip their
zero imaginary plane (two products instead of four).
"""

from __future__ import annotations

import torch


def _bf16_plane(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def einsum_complex_bf16(subscripts: str, a: torch.Tensor, b: torch.Tensor,
                        out_dtype=torch.complex64) -> torch.Tensor:
    a_c, b_c = a.is_complex(), b.is_complex()
    ar = _bf16_plane(a.real if a_c else a)
    br = _bf16_plane(b.real if b_c else b)
    ee = lambda x, y: torch.einsum(subscripts, x, y)
    if a_c and b_c:
        ai, bi = _bf16_plane(a.imag), _bf16_plane(b.imag)
        rr = ee(ar, br) - ee(ai, bi)
        ri = ee(ar, bi) + ee(ai, br)
    elif a_c:
        ai = _bf16_plane(a.imag)
        rr, ri = ee(ar, br), ee(ai, br)
    elif b_c:
        bi = _bf16_plane(b.imag)
        rr, ri = ee(ar, br), ee(ar, bi)
    else:
        return ee(ar, br).to(out_dtype)
    return torch.complex(rr, ri).to(out_dtype)
