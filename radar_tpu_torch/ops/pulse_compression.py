"""Segmented pulse compression — port of
``radar_tpu/ops/pulse_compression.py:36-262``.

The reference (fun_process_single_frame.m:99-127) compresses three range
segments (narrow FIR, medium and long LFM matched filters) and splices them
into ``n_total_gate`` gates, each segment's output indexed with global gate
indices into its own causal convolution (ref :123-126). Two formulations:

- ``pulse_compress``: the reference's, FFT fast convolution per segment
  (``make_plan(trim=True)`` cuts each segment to the samples its gates
  read, which changes no value; ``trim=False`` keeps the reference's
  2^nextpow2 full-segment sizes);
- ``pulse_compress_matmul``: each causal convolution as chunked [window,
  out_chunk] products against host-built filter matrices — exact direct
  convolution. ``to_device`` moves a plan's matrices to the device once, so
  a frame pays no host-to-device copy.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import numpy as np
import torch

from ..utils.signal import next_pow2


class PCPlan(NamedTuple):
    """Splice/FFT plan of ``pulse_compress`` (host side)."""

    seg_start_narrow: int
    seg_start_medium: int
    seg_start_long: int
    fir_delay: int
    n_taps: int
    gate_narrow_end: int
    gate_medium_end: int
    n_total_gate: int
    narrow_len: int
    med_len: int           # -1: to the end of the PRT (trim=False)
    long_len: int
    nfft_narrow: int
    nfft_med: int
    nfft_long: int


def make_plan(precomp, trim: bool = True) -> PCPlan:
    g1, g2, _ = precomp.gate_splits
    gate_medium_end = g1 + g2
    n_total = precomp.n_total_gate
    n_taps = len(precomp.mf_narrow)
    narrow_len = g1 + precomp.fir_delay
    return PCPlan(
        seg_start_narrow=precomp.seg_start_narrow,
        seg_start_medium=precomp.seg_start_medium,
        seg_start_long=precomp.seg_start_long,
        fir_delay=precomp.fir_delay, n_taps=n_taps,
        gate_narrow_end=g1, gate_medium_end=gate_medium_end,
        n_total_gate=n_total, narrow_len=narrow_len,
        med_len=gate_medium_end if trim else -1,
        long_len=n_total if trim else -1,
        nfft_narrow=next_pow2(narrow_len + n_taps - 1),
        nfft_med=(next_pow2(gate_medium_end + len(precomp.mf_medium_win) - 1)
                  if trim else precomp.n_fft_med),
        nfft_long=(next_pow2(n_total + len(precomp.mf_long_win) - 1)
                   if trim else precomp.n_fft_long))


def _fft_causal_conv(x: torch.Tensor, h, nfft: int, lo: int,
                     hi: int) -> torch.Tensor:
    """Output columns [lo, hi) of the causal linear convolution of x (last
    axis) with the filter h, by FFT: col n = sum_k h[k] * x[n - k]."""
    h_t = torch.as_tensor(np.ascontiguousarray(h), device=x.device)
    hf = torch.fft.fft(h_t.to(x.dtype), n=nfft)
    y = torch.fft.ifft(torch.fft.fft(x, n=nfft, dim=-1) * hf, n=nfft, dim=-1)
    return y[..., lo:hi]


def pulse_compress(iq_beams: torch.Tensor, precomp,
                   plan: PCPlan | None = None,
                   trim: bool = True) -> torch.Tensor:
    """[pulses, samples, beams] -> [pulses, n_total_gate, beams] by FFT."""
    if plan is None:
        plan = make_plan(precomp, trim=trim)
    num_s = iq_beams.shape[1]
    x = iq_beams.transpose(1, 2)                       # [P, B, S]
    # narrow: causal FIR + group-delay advance -> gates [0, g1)
    a = plan.seg_start_narrow
    p1 = _fft_causal_conv(x[..., a:a + plan.narrow_len + plan.n_taps],
                          precomp.mf_narrow, plan.nfft_narrow,
                          plan.fir_delay,
                          plan.fir_delay + plan.gate_narrow_end)
    # medium LFM -> gates [g1, g1+g2)
    a = plan.seg_start_medium
    stop = a + plan.med_len if plan.med_len > 0 else num_s
    p2 = _fft_causal_conv(x[..., a:stop], precomp.mf_medium_win,
                          plan.nfft_med, plan.gate_narrow_end,
                          plan.gate_medium_end)
    # long LFM -> gates [g1+g2, n_total)
    a = plan.seg_start_long
    stop = a + plan.long_len if plan.long_len > 0 else num_s
    p3 = _fft_causal_conv(x[..., a:stop], precomp.mf_long_win,
                          plan.nfft_long, plan.gate_medium_end,
                          plan.n_total_gate)
    return torch.cat([p1, p2, p3], dim=-1).transpose(1, 2)


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
