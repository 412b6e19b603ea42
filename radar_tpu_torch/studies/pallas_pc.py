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
(``ops.noise_rdm._banded``). Kernel K8 computes it on the card. With
bfloat16 operands (the TPU's default) it is two kernels of
``csrc/band_pc_sm90.cu``: ``stage_kernel`` writes every segment's padded
buffer, rounded once, into two bfloat16 planes [2, B*P, ld]
(``stage_layout``), then the strip GEMM ``strip_pc_kernel`` (TMA + wgmma
on the Toeplitz strip ``SegSpec.strip``, shared with K7 and K9 through
``ops.noise_rdm.strip_pc``) computes all three segments in one launch.
At float32 the staging kernel writes float32 planes in the same layout,
then K1's 3xTF32 strip GEMM in K4's one-launch form (``k8_pc_kernel`` of
``csrc/noise_rdm_sm90.cu``: the main pass hi*hi and the correction pass
hi*lo + lo*hi on the same rows, joined in its epilogue) multiplies them by
the split strip ``SegSpec.strip_tf32``, all three segments in one launch.
``pulse_compress_noise_plain`` is its plain version, which the wrapper
runs only for CPU tensors; ``pulse_compress_noise_strips`` is the plain
twin of the bfloat16 kernels' schedule (same staging, same strips,
per-block sums) and ``pulse_compress_noise_tf32`` that of the float32
kernels' 3xTF32 arithmetic, for the tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import noise_rdm as nr
from ..ops.noise_rdm import (STRIP_BN, _banded, _split_tf32, round_mul,
                             strip_bf16, strip_tf32, toeplitz_strip)

launch_count = 0          # K8 launches (one per pulse_compress_noise call)
stage_launch_count = 0    # K8's staging kernel (every call)
tf32_pc_launch_count = 0  # K8's 3xTF32 strip-GEMM launches (f32 calls)


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
    strip: torch.Tensor   # [2, STRIP_BN, k_pad] bf16 strip (``strip_bf16``)
    strip_tf32: torch.Tensor  # [4, STRIP_BN, k_pad] f32 split (``strip_tf32``)


class PallasPCPlan(NamedTuple):
    segments: tuple
    s_compact: int        # total compact-z samples (== sum of r_len)
    n_gates: int
    stage: tuple          # K8's staged planes: ((off, width) a segment, ld)


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
        mr, mi = plane(m.real), plane(m.imag)
        segs.append(SegSpec(c0=c0, r_len=r_len, pad_front=pad_front,
                            pad_tail=max(xlen_needed - (pad_front + r_len), 0),
                            j_len=j_len, tile=t, window=w_pad, mr=mr, mi=mi,
                            taps=lh, strip=strip_bf16(mr, mi, lh),
                            strip_tf32=strip_tf32(mr, mi, lh)))
        c0 += r_len
    return PallasPCPlan(segments=tuple(segs), s_compact=c0, n_gates=n_total,
                        stage=stage_layout(segs))


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


def stage_layout(segments) -> tuple:
    """Where K8's staging puts each segment's padded buffer (zero history,
    samples, zeros up to a multiple of 8 columns, TMA's 16-byte row rule for
    bf16, and for f32 too) in its planes: ((off, width) per segment, row
    length ld)."""
    cols, off = [], 0
    for seg in segments:
        width = -(-(seg.pad_front + seg.r_len) // 8) * 8
        cols.append((off, width))
        off += width
    return tuple(cols), off


def stage_planes_plain(z: torch.Tensor, plan: PallasPCPlan,
                       dtype=torch.bfloat16):
    """Plain version of K8's staging kernel: compact z [B, P, s_compact] ->
    (xr, xi) [B*P, ld] ``dtype`` in the layout of ``stage_layout``."""
    rows = z.shape[0] * z.shape[1]
    cols, ld = plan.stage
    zf = z.reshape(rows, z.shape[2])
    xr = torch.zeros((rows, ld), dtype=dtype, device=z.device)
    xi = torch.zeros_like(xr)
    for seg, (off, _) in zip(plan.segments, cols):
        a = off + seg.pad_front
        piece = zf[:, seg.c0:seg.c0 + seg.r_len]
        xr[:, a:a + seg.r_len] = piece.real.to(dtype)
        xi[:, a:a + seg.r_len] = piece.imag.to(dtype)
    return xr, xi


def pulse_compress_noise_strips(z: torch.Tensor, plan: PallasPCPlan,
                                mul_dtype=torch.bfloat16,
                                bn: int = STRIP_BN) -> torch.Tensor:
    """Plain twin of the bf16 kernels' schedule: the staged planes
    (``stage_planes_plain``), then per segment and bn-gate block j0 the
    product of the samples j0 .. j0+k_pad-1 of every row (zeros beyond the
    segment's buffer, as TMA fills them) with the strip
    (``ops.noise_rdm.toeplitz_strip`` of the rounded filter), float32 sums.
    Same function as ``pulse_compress_noise_plain``."""
    num_b, num_p, _ = z.shape
    xr, xi = stage_planes_plain(z, plan, mul_dtype)
    x = torch.complex(xr.float(), xi.float())
    pieces = []
    for seg, (off, width) in zip(plan.segments, plan.stage[0]):
        col = lambda m: toeplitz_strip(round_mul(m[:seg.taps, 0], mul_dtype),
                                       bn)
        s = torch.complex(col(seg.mr), col(seg.mi)).to(z.device)
        k_pad, nb = s.shape[0], -(-seg.j_len // bn)
        xs = torch.nn.functional.pad(
            x[:, off:off + width], (0, max((nb - 1) * bn + k_pad - width, 0)))
        y = torch.matmul(xs.unfold(-1, k_pad, bn)[:, :nb], s)
        pieces.append(y.reshape(x.shape[0], nb * bn)[:, :seg.j_len])
    return torch.cat(pieces, dim=-1).reshape(num_b, num_p, plan.n_gates)


def pulse_compress_noise_tf32(z: torch.Tensor, plan: PallasPCPlan,
                              bn: int = STRIP_BN) -> torch.Tensor:
    """Plain twin of the float32 kernels' arithmetic (3xTF32): the staged
    float32 planes, each value split into TF32 parts (``_split_tf32``: hi,
    lo), the plan's split strip ``strip_tf32`` (hi, lo), and per segment and
    bn-gate block the strip schedule of ``pulse_compress_noise_strips``
    taken twice: the main pass hi*hi, the correction pass hi*lo + lo*hi
    (the data's hi there with its low 13 bits dropped, as the tensor cores
    read it from shared memory), then their sum. Same function as
    ``pulse_compress_noise_plain`` at float32, within 2^-21 of each
    product."""
    num_b, num_p, _ = z.shape
    xr, xi = stage_planes_plain(z, plan, torch.float32)
    drop = lambda x: (x.contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)
    parts = [_split_tf32(x) for x in (xr, xi)]
    hi = torch.complex(parts[0][0], parts[1][0])
    lo = torch.complex(parts[0][1], parts[1][1])
    hi_rz = torch.complex(drop(xr), drop(xi))
    pieces = []
    for seg, (off, width) in zip(plan.segments, plan.stage[0]):
        st = seg.strip_tf32.to(z.device)
        s_hi, s_lo = torch.complex(st[0].T, st[2].T), torch.complex(st[1].T,
                                                                    st[3].T)
        k_pad, nb = s_hi.shape[0], -(-seg.j_len // bn)

        def blocks(x, s):
            xs = torch.nn.functional.pad(
                x[:, off:off + width],
                (0, max((nb - 1) * bn + k_pad - width, 0)))
            return torch.matmul(xs.unfold(-1, k_pad, bn)[:, :nb], s)

        y = blocks(hi, s_hi) + (blocks(hi_rz, s_lo) + blocks(lo, s_hi))
        pieces.append(y.reshape(hi.shape[0], nb * bn)[:, :seg.j_len])
    return torch.cat(pieces, dim=-1).reshape(num_b, num_p, plan.n_gates)


def _stage(z: torch.Tensor, plan: PallasPCPlan, dtype, stream: int):
    """K8's staging kernel (``sp_stage``): the planes [2, B*P, ld] of
    ``dtype`` (bfloat16 or float32) and, per segment, the strip GEMMs'
    8-value table head (the pointers of its xr and xi columns, its width
    and the row stride ld)."""
    global stage_launch_count
    import ctypes

    from .. import _build

    lib = _build.load("band_pc_sm90")
    num_b, num_p, s_c = z.shape
    rows = num_b * num_p
    cols, ld = plan.stage
    x = torch.empty((2, rows, ld), dtype=dtype, device=z.device)
    vals = [v for seg, (off, width) in zip(plan.segments, cols)
            for v in (seg.c0, seg.r_len, seg.pad_front, off, width)]
    rc = lib.sp_stage(z.data_ptr(), s_c, rows, len(cols),
                      (ctypes.c_int * len(vals))(*vals), ld, x.data_ptr(),
                      int(dtype == torch.float32), stream)
    _build.check(lib, rc, "sp_stage")
    stage_launch_count += 1
    # each segment's columns of the two planes (16-byte aligned: the
    # offsets and ld are multiples of 8)
    size = x.element_size()
    xr, xi = x.data_ptr(), x.data_ptr() + size * rows * ld
    heads = [(xr + size * off, xi + size * off, width, ld)
             for off, width in cols]
    return x, heads


def _pc_cuda(z: torch.Tensor, plan: PallasPCPlan, mul_dtype):
    global launch_count, tf32_pc_launch_count
    import ctypes

    from .. import _build

    dev = z.device
    num_b, num_p, _ = z.shape
    if z.dtype != torch.complex64 or not z.is_contiguous():
        z = z.to(torch.complex64).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = mul_dtype == torch.bfloat16
    # the strips' type and shape are the plan's
    strips = [seg.strip if bf16 else seg.strip_tf32 for seg in plan.segments]
    if any(st.device != dev for st in strips):
        raise ValueError("the plan's strips must be on z's device")
    # the staging kernel first, then, while it runs, the strip GEMM's
    # arguments and launch (x, the staged planes, stays referenced until
    # then, so that out cannot take its memory)
    x, heads = _stage(z, plan, mul_dtype, stream)
    out = torch.empty((num_b, num_p, plan.n_gates), dtype=torch.complex64,
                      device=dev)
    vals, g0 = [], 0
    for seg, st, head in zip(plan.segments, strips, heads):
        vals += [*head, st.data_ptr(), st.shape[2], seg.j_len, g0]
        g0 += seg.j_len
    if bf16:
        nr.launch_strips(vals, num_b * num_p, plan.n_gates, stream, out=out)
    else:
        lib = _build.load("noise_rdm_sm90")
        rc = lib.k8_tf32_pc(len(plan.segments),
                            (ctypes.c_longlong * len(vals))(*vals),
                            num_b * num_p, plan.n_gates, out.data_ptr(),
                            stream)
        _build.check(lib, rc, "k8_tf32_pc")
        tf32_pc_launch_count += 1
    launch_count += 1
    return out


def pulse_compress_noise(z: torch.Tensor, plan: PallasPCPlan,
                         mul_dtype=torch.bfloat16) -> torch.Tensor:
    """White-noise PC: compact z [beams, pulses, s_compact] complex ->
    [beams, pulses, n_gates] complex64, with ``mul_dtype`` (float32 or
    bfloat16) operands and float32 sums and output. A CUDA ``z`` runs K8
    (or raises): the staging kernel, then at bfloat16 the strip GEMM, at
    float32 K1's 3xTF32 strip GEMM (both passes in one launch). A CPU
    ``z`` runs the plain version."""
    if z.dim() != 3 or z.shape[2] != plan.s_compact:
        raise ValueError(f"z must be [B, P, {plan.s_compact}], got "
                         f"{tuple(z.shape)}")
    if mul_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("mul_dtype is torch.float32 or torch.bfloat16")
    if z.is_cuda:
        return _pc_cuda(z, plan, mul_dtype)
    return pulse_compress_noise_plain(z, plan, mul_dtype)
