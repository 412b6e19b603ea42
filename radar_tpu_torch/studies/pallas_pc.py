"""Banded-convolution pulse compression of white noise — port of
``radar_tpu/studies/pallas_pc.py`` (``SegSpec``, ``PallasPCPlan``,
``make_pallas_pc_plan``, ``pulse_compress_noise_pallas``).

Each segment's causal convolution (reference fun_process_single_frame.m:
99-127 semantics, zero history at the segment start) is a banded product of
overlapping [pulses, W] windows of the padded per-segment buffer with one
[W, T] filter matrix, with ``mul_dtype`` operands and float32 sums, spliced
to ``n_total_gate`` outputs: the arithmetic of
``pulse_compress_matmul(precision="bf16")`` up to the order of the sums.

STUDY ARTIFACT, as in the reference: it lost its integrated A/B on the TPU
and nothing in the frame calls it; the fused noise-RDM kernels
(``ops/noise_rdm.py``) own the path and share its banded filter matrix
(``ops.noise_rdm._banded``). Kernel K8 (``csrc/rdm_variants.cu``,
``band_pc_kernel`` reading the compact cube) computes it on the card;
``pulse_compress_noise_plain`` is its plain version, which the wrapper runs
only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.noise_rdm import _banded, round_mul

launch_count = 0          # K8 launches (one per pulse_compress_noise call)


class SegSpec(NamedTuple):
    c0: int               # segment's first sample in the compact-z layout
    r_len: int            # samples read from compact z
    pad_front: int        # zero history prepended (causal edge)
    pad_tail: int         # zeros appended to reach ntiles*T + W - T
    j_len: int            # true output gates of this segment
    tile: int             # output tile T
    window: int           # input window W = T + L - 1, 128-aligned
    mr: torch.Tensor      # [W, T] real filter matrix, float32
    mi: torch.Tensor      # [W, T] imag filter matrix
    taps: int             # filter length L (rows of the band per column)


class PallasPCPlan(NamedTuple):
    segments: tuple
    s_compact: int        # total compact-z samples (== sum of r_len)
    n_gates: int


def make_pallas_pc_plan(precomp, tile: int = 512, *,
                        device="cuda") -> PallasPCPlan:
    """Per-segment uniform banded plan in the compact-z layout (the
    concatenation of the three segments' read regions, the same sample
    union as ``ops.pulse_compression.compact_noise_plan``); the geometry of
    the JAX ``make_pallas_pc_plan``, the filter planes on ``device``."""
    g1, g2, _ = precomp.gate_splits
    n_total = precomp.n_total_gate
    fd = precomp.fir_delay
    segs = []
    c0 = 0
    for h, out_lo, out_hi in (
            (np.asarray(precomp.mf_narrow, np.complex128), fd, fd + g1),
            (np.asarray(precomp.mf_medium_win), g1, g1 + g2),
            (np.asarray(precomp.mf_long_win), g1 + g2, n_total)):
        lh = len(h)
        t = min(tile, int(2 ** np.ceil(np.log2(out_hi - out_lo))))
        r0 = max(out_lo - (lh - 1), 0)
        r_len = out_hi - r0
        pad_front = (lh - 1) - (out_lo - r0)
        j_len = out_hi - out_lo
        ntiles = -(-j_len // t)
        w = t + lh - 1
        w_pad = -(-w // 128) * 128
        xlen_needed = (ntiles - 1) * t + w_pad
        m = np.pad(_banded(h, t), ((0, w_pad - w), (0, 0)))
        plane = lambda x: torch.as_tensor(
            np.ascontiguousarray(x.astype(np.float32))).to(device)
        segs.append(SegSpec(c0=c0, r_len=r_len, pad_front=pad_front,
                            pad_tail=max(xlen_needed - (pad_front + r_len), 0),
                            j_len=j_len, tile=t, window=w_pad,
                            mr=plane(m.real), mi=plane(m.imag), taps=lh))
        c0 += r_len
    return PallasPCPlan(segments=tuple(segs), s_compact=c0, n_gates=n_total)


def pulse_compress_noise_plain(z: torch.Tensor, plan: PallasPCPlan,
                               mul_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K8: the padded segment buffers, rounded to
    ``mul_dtype``, unfolded into windows and multiplied by the rounded
    filter matrices in float32. Returns [B, P, n_gates] complex64."""
    num_b, num_p, _ = z.shape
    zr, zi = round_mul(z.real, mul_dtype), round_mul(z.imag, mul_dtype)
    pieces = []
    for seg in plan.segments:
        ntiles = -(-seg.j_len // seg.tile)
        pad = lambda x: torch.nn.functional.pad(
            x[:, :, seg.c0:seg.c0 + seg.r_len], (seg.pad_front, seg.pad_tail))
        x = torch.complex(pad(zr), pad(zi))
        win = x.unfold(-1, seg.window, seg.tile)[:, :, :ntiles]
        m = torch.complex(round_mul(seg.mr, mul_dtype),
                          round_mul(seg.mi, mul_dtype)).to(z.device)
        pc = torch.matmul(win, m)                        # [B, P, nt, T]
        pieces.append(pc.reshape(num_b, num_p,
                                 ntiles * seg.tile)[..., :seg.j_len])
    return torch.cat(pieces, dim=-1)


def _pc_cuda(z: torch.Tensor, plan: PallasPCPlan, mul_dtype):
    global launch_count
    import ctypes

    from .. import _build

    lib = _build.load("rdm_variants")
    dev = z.device
    num_b, num_p, s_c = z.shape
    z = z.to(torch.complex64).contiguous()
    out = torch.empty((num_b, num_p, plan.n_gates), dtype=torch.complex64,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g0 = 0
    for seg in plan.segments:
        if seg.mr.device != dev:
            raise ValueError("the plan's filters must be on z's device")
        mr = round_mul(seg.mr, mul_dtype).contiguous()
        mi = round_mul(seg.mi, mul_dtype).contiguous()
        rc = lib.rv_band_pc(int(mul_dtype == torch.bfloat16), 1, None, None,
                            z.data_ptr(), s_c, seg.c0, seg.r_len,
                            seg.pad_front, 0, 0, 0, ctypes.c_float(0.0),
                            mr.data_ptr(), mi.data_ptr(), seg.window,
                            seg.tile, seg.taps, num_b, num_p, seg.j_len, g0,
                            plan.n_gates, None, None, out.data_ptr(), stream)
        _build.check(lib, rc, "rv_band_pc")
        g0 += seg.j_len
    launch_count += 1
    return out


def pulse_compress_noise(z: torch.Tensor, plan: PallasPCPlan,
                         mul_dtype=torch.bfloat16) -> torch.Tensor:
    """White-noise PC: compact z [beams, pulses, s_compact] complex ->
    [beams, pulses, n_gates] complex64, with ``mul_dtype`` (float32 or
    bfloat16) operands and float32 sums and output. A CUDA ``z`` runs K8
    (or raises); a CPU ``z`` the plain version."""
    if z.dim() != 3 or z.shape[2] != plan.s_compact:
        raise ValueError(f"z must be [B, P, {plan.s_compact}], got "
                         f"{tuple(z.shape)}")
    if mul_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("mul_dtype is torch.float32 or torch.bfloat16")
    if z.is_cuda:
        return _pc_cuda(z, plan, mul_dtype)
    return pulse_compress_noise_plain(z, plan, mul_dtype)
