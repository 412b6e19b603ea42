"""Segmented pulse compression as banded-Toeplitz matmuls — port of
``radar_tpu/ops/pulse_compression.py:95-211``.

The reference (fun_process_single_frame.m:99-127) compresses three range
segments (narrow FIR, medium and long LFM matched filters) and splices them
into ``n_total_gate`` gates. Each causal convolution becomes chunked
[window, out_chunk] products against host-built filter matrices — exact
direct convolution. ``to_device`` moves a plan's matrices to the device
once, so a frame pays no host-to-device copy.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import numpy as np
import torch


class MatmulPlan(NamedTuple):
    """chunks: (seg_start_sample, window_len, M [window_len, out_len]) in
    splice order; concatenating the chunk outputs yields all gates."""

    chunks: tuple


def _toeplitz_chunks(h: np.ndarray, seg_start: int, out_lo: int, out_hi: int,
                     chunk: int) -> list:
    """Chunks for causal-conv outputs [out_lo, out_hi) of a segment whose
    samples start at ``seg_start`` in the PRT."""
    lh = len(h)
    out = []
    o0 = out_lo
    while o0 < out_hi:
        o1 = min(o0 + chunk, out_hi)
        w0 = max(o0 - (lh - 1), 0)
        wlen = o1 - w0
        m = np.zeros((wlen, o1 - o0), dtype=np.complex128)
        for j in range(o1 - o0):
            # y[o0+j] = sum_m h[(o0+j) - (w0+m)] * x[w0+m]
            k = (o0 + j) - (w0 + np.arange(wlen))
            sel = (k >= 0) & (k < lh)
            m[sel, j] = h[k[sel]]
        out.append((seg_start + w0, wlen, m))
        o0 = o1
    return out


def make_matmul_plan(precomp, chunk: int = 256) -> MatmulPlan:
    g1, g2, _ = precomp.gate_splits
    gate_medium_end = g1 + g2
    n_total = precomp.n_total_gate
    fd = precomp.fir_delay
    chunks = []
    chunks += _toeplitz_chunks(np.asarray(precomp.mf_narrow, np.complex128),
                               precomp.seg_start_narrow, fd, fd + g1, chunk)
    chunks += _toeplitz_chunks(np.asarray(precomp.mf_medium_win),
                               precomp.seg_start_medium, g1, gate_medium_end,
                               chunk)
    chunks += _toeplitz_chunks(np.asarray(precomp.mf_long_win),
                               precomp.seg_start_long, gate_medium_end,
                               n_total, chunk)
    return MatmulPlan(chunks=tuple(chunks))


def compact_noise_plan(mplan: MatmulPlan) -> tuple[MatmulPlan, int]:
    """Remap the chunk read windows into a compacted sample space holding
    only the samples PC reads; returns (remapped plan, compact_len)."""
    intervals = sorted((w0, w0 + wlen) for w0, wlen, _ in mplan.chunks)
    merged: list = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    offset = {}
    pos = 0
    for a, b in merged:
        offset[a] = (a, pos)
        pos += b - a
    starts = sorted(offset)

    def remap(w0: int) -> int:
        a, p = offset[starts[bisect.bisect_right(starts, w0) - 1]]
        return p + (w0 - a)

    chunks = tuple((remap(w0), wlen, m) for w0, wlen, m in mplan.chunks)
    return MatmulPlan(chunks=chunks), pos


def to_device(mplan: MatmulPlan, device, dtype=torch.complex64) -> MatmulPlan:
    """The plan with its filter matrices as ``dtype`` tensors on
    ``device``."""
    return MatmulPlan(chunks=tuple(
        (w0, wlen, torch.as_tensor(m).to(device=device, dtype=dtype))
        for w0, wlen, m in mplan.chunks))


def pulse_compress_matmul(iq_beams: torch.Tensor, mplan: MatmulPlan,
                          precision: str = "f32") -> torch.Tensor:
    """[pulses, samples, beams] -> [pulses, n_total_gate, beams]."""
    dtype = iq_beams.dtype
    if precision == "bf16":
        from .precision import einsum_complex_bf16
    pieces = []
    for w0, wlen, m in mplan.chunks:
        seg = iq_beams[:, w0:w0 + wlen, :]
        m = torch.as_tensor(m, device=iq_beams.device)
        if precision == "bf16":
            pieces.append(einsum_complex_bf16("pwb,wj->pjb", seg, m,
                                              out_dtype=dtype))
        else:
            pieces.append(torch.einsum("pwb,wj->pjb", seg, m.to(dtype)))
    return torch.cat(pieces, dim=1)
