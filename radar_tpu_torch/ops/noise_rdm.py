"""Fused noise range-Doppler map — port of ``radar_tpu/ops/pallas_rdm.py``
(``make_rdm_plan``, ``noise_rdm_pallas_gen`` rolling and not, its
planes-input sibling ``noise_rdm_pallas_planes``, ``noise_rdm_pallas`` on a
compact cube and the plane exporter ``gen_noise_planes_pallas``).

Per pulse-compression segment (narrow FIR, medium and long LFM matched
filter) the map is

  rdm[b] = sum_c L[b, c] * D @ PC_seg(x_c) + sum_k st[k, b] * dv[k] (x) pb[k]

with x_c the white uniform noise planes of beam c, PC_seg the segment's
causal convolution, D the MTD DFT matrix, L the 13x13 Cholesky factor of
the DBF-output noise covariance and (dv, pb, st) the rank-K signal factors.

Kernel K1 (``csrc/noise_rdm_sm90.cu``) computes this on the card's tensor
cores: the PC of each segment as a strip GEMM and the DFT as a GEMM, both
in 3xTF32 (each f32 operand split into TF32 parts hi + lo, three products
summed in f32: ``_split_tf32``, the plan's ``strip_tf32`` and ``d_tf32``),
the beam mix between them. It reads given planes (planes mode) or, in draw
mode, the planes kernel K1c writes first (``gen_noise_planes``), so the
two modes agree bit for bit. Kernel K4 (the same source), the schedule of
the TPU's non-rolling kernel, computes the same map through K1's GEMMs with
its data drawn inside the PC's blocks, no noise cube in device memory,
``beams_per_step`` beams walked by a block. K1 and K4 hold float32
accuracy. K1 has the two modes of the TPU kernel's kernel-maps tail:
``emit_maps`` also writes the adjacent-beam sum maps of its unrounded map
into K2's padded qvg layout (``maps_buffer``; plain version
``pair_maps_plain``), and ``out_dtype=torch.bfloat16`` rounds its map to
bfloat16 values; both in one epilogue that walks the beams
(``add_maps_kernel``), in place of the sum of the DFT's passes.

The planes kernel's other schedules (``variant=`` of ``noise_rdm_pallas``,
the TPU's A/B entry point) run in the TPU's arithmetic for a multiply type
``mul_dtype`` (float32, or bfloat16 as the TPU's perf path runs): kernels
K10 (``"resident"``), K7 (``"stacked"``, and ``stacked=True`` in draw
mode) and K9 (``"allbeams"``). They mix the beams after the DFT;
``"resident"`` and ``stacked=True`` may round their output to bfloat16.
At float32 the three take one sequence of K1's 3xTF32 GEMMs
(``_variant_tf32``: K1's strip-GEMM PC, or K4's drawing PC in draw mode,
its passes joined, K1's DFT GEMM, then an epilogue that mixes, adds the
signal and rounds), so they agree bit for bit. At bfloat16 they round
(nearest even) the planes, the filter, D and L, the PC result and the DFT
result, and accumulate every product in float32: the PC is the strip GEMM
of ``csrc/band_pc_sm90.cu`` (``strip_pc``: TMA + wgmma on the Toeplitz
strip of each segment's filter, rounded to bfloat16 once per plan,
``strip``), which K8 (``studies/pallas_pc.py``) shares; in K7's draw mode
its producers draw the data's stages themselves (``strip_pc_draw``; plain
twin of a drawn stage ``strip_draw_stage_plain``), so draw mode equals
planes mode on K1c's planes bit for bit; the DFT is the wgmma GEMM of
``csrc/rdm_sm90.cu`` (``dft``, on the plan's rounded D, ``d_bf16``); then
``csrc/rdm_variants.cu``'s mix. L's rounded copy is kept for the latest L
(``_rounded_l``), not made anew on every call.

``noise_rdm_plain`` is the plain PyTorch version of every schedule,
``philox_planes`` that of K1c; the wrappers run the kernels for CUDA
tensors and the plain versions only on the CPU.

Noise draws. The TPU kernel draws from the TPU's hardware generator; the
port uses a counter-based Philox4x32-10 keyed by the frame seed's two
32-bit words and counted by (absolute sample index within the segment
buffer, pulse, beam, segment). Any window covering a sample regenerates
the same value, the property the banded convolution relies on. Philox does
not reproduce the TPU's bits, so draws are held by statistics and by the
bit-identity of ``philox_planes`` (plain) with the kernel's own draws.
Each draw uses words 0 and 1 of one Philox block for the (re, im) rails:
24-bit integers ``k = w >> 8`` mapped to ``(k + 0.5 - 2^23) * 2a/2^24``
with ``a = sqrt(1.5)`` (zero mean, rail variance 1/2); samples before
``pad_front`` (pre-PRT causal history) are zero.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

A_UNIF = float(np.sqrt(1.5))          # unit rail variance: a^2/3 = 1/2
# (k + 0.5 - 2^23) * U_SCALE maps a 24-bit integer to U[-a, a)
U_SCALE = float(np.float32(2.0 * A_UNIF * 2.0 ** -24))

VARIANTS = ("beams", "resident", "stacked", "allbeams")
STRIP_BN = 128                        # gates of a strip-GEMM block
STRIP_BK = 64                         # k depth of its stages (128-byte rows)
TF32_BK = 32                          # k depth of K1's TF32 GEMM stages

launch_count = 0                      # K1 calls (PC + mix + DFT GEMMs; with
                                      # K1c's planes first in draw mode)
k4_launch_count = 0                   # K4 calls (rolling=False)
k4_pc_launch_count = 0                # K4's PC launches (its drawing GEMM;
                                      # K7's f32 draw mode too)
k1c_launch_count = 0                  # K1c launches (gen_noise_planes calls)
k1c_draw_launch_count = 0             # K1c launches inside K1's draw mode
k7_launch_count = 0                   # K7 launches ("stacked", stacked=True)
k9_launch_count = 0                   # K9 launches ("allbeams")
k10_launch_count = 0                  # K10 launches ("resident")
strip_pc_launch_count = 0             # strip-GEMM launches (bf16 PC of K7,
                                      # K10, K9 planes mode and of K8)
strip_pc_draw_launch_count = 0        # strip-GEMM launches in draw mode
                                      # (K7's bf16 draw mode)
dft_launch_count = 0                  # bf16 DFT-GEMM launches (K10, K7, K9)
tf32_pc_launch_count = 0              # K1's 3xTF32 PC launches (K1 and the
                                      # f32 planes schedules K10, K7, K9)
tf32_dft_launch_count = 0             # K1's 3xTF32 DFT launches (K1, K4
                                      # and the f32 schedules)
maps_launch_count = 0                 # K1's emit_maps / bf16-output
                                      # epilogue (add_maps_kernel) launches


class RdmSegSpec(NamedTuple):
    c0: int             # first sample in the compact-z layout
    r_len: int          # samples read from compact z
    pad_front: int      # zero causal history
    pad_tail: int
    j_len: int          # true output gates
    g0: int             # first output gate of the segment
    tile: int           # output gate tile T
    window: int         # padded input window W (128-aligned)
    taps: torch.Tensor  # [lh] complex64 filter h (causal conv)
    mp: torch.Tensor    # [W, T] complex64 banded filter (plain version)
    strip: torch.Tensor  # [2, STRIP_BN, k_pad] bf16 strip (``strip_bf16``)
    strip_tf32: torch.Tensor  # [4, STRIP_BN, k_pad] f32 split (``strip_tf32``)

    @property
    def xlen(self) -> int:
        """Samples of the segment buffer that any output reads."""
        return (-(-self.j_len // self.tile) - 1) * self.tile + self.window


class RdmPlan(NamedTuple):
    segments: tuple
    s_compact: int
    n_gates: int
    n_dop: int
    n_pulses: int
    d: torch.Tensor     # [V, P] complex64 MTD DFT (window+fftshift folded)
    d_tf32: torch.Tensor  # [4, V128, P4] f32 split of D (``d_tf32``)
    d_bf16: torch.Tensor  # [2, V, P8] bf16 planes of D (``d_bf16``)


def _banded(h: np.ndarray, tile: int) -> np.ndarray:
    """[tile+len(h)-1, tile] banded filter: column t holds h reversed at
    offset t (causal linear convolution)."""
    lh = len(h)
    w = tile + lh - 1
    m = np.zeros((w, tile), np.complex128)
    for tt in range(tile):
        k = tt + lh - 1 - np.arange(w)
        sel = (k >= 0) & (k < lh)
        m[sel, tt] = h[k[sel]]
    return m


def toeplitz_strip(col: torch.Tensor, bn: int = STRIP_BN,
                   bk: int = STRIP_BK) -> torch.Tensor:
    """The strip S = M[:bn+lh-1, :bn] of a banded filter M[k, n] =
    h[n+lh-1-k], from its first column ``col`` = M[:lh, 0] (h reversed), with
    zero rows up to a multiple of ``bk``: [k_pad, bn]. M is Toeplitz, so S
    gives every bn-gate block of M: M[n0 + k, n0 + n] = S[k, n]."""
    lh = col.shape[0]
    k_pad = -(-(bn + lh - 1) // bk) * bk
    d = (torch.arange(k_pad, device=col.device)[:, None]
         - torch.arange(bn, device=col.device)[None, :])
    return torch.where((d >= 0) & (d < lh), col[d.clamp(0, lh - 1)],
                       torch.zeros((), dtype=col.dtype, device=col.device))


def strip_bf16(mr: torch.Tensor, mi: torch.Tensor, lh: int) -> torch.Tensor:
    """[2, STRIP_BN, k_pad] bfloat16: the strips of the real and imaginary
    float32 banded-filter planes ``mr``, ``mi`` [W, T], transposed so k is
    contiguous (the strip GEMM's K-major operand), each value rounded once to
    bfloat16 (nearest even, as ``round_mul``)."""
    return torch.stack([toeplitz_strip(m[:lh, 0]).T for m in (mr, mi)]).to(
        torch.bfloat16).contiguous()


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (its top 19 bits) to nearest, ties away
    from zero, as the card's ``cvt.rna.tf32.f32``: integer ops on the bits
    (add half of the dropped 13 bits' unit, clear them)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(x: torch.Tensor):
    """(hi, lo): the TF32 parts of f32 ``x``, hi = rna(x), lo = rna(x - hi),
    so hi + lo = x within 2^-21 |x| and hi*hi + hi*lo + lo*hi carries a
    product to about that accuracy (3xTF32)."""
    hi = _round_tf32(x)
    return hi, _round_tf32(x.to(torch.float32) - hi)


def _split_planes(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """[4, ...] f32: re_hi, re_lo, im_hi, im_lo (K1's constant operands)."""
    return torch.stack([*_split_tf32(re), *_split_tf32(im)]).contiguous()


def strip_tf32(mr: torch.Tensor, mi: torch.Tensor, lh: int) -> torch.Tensor:
    """[4, STRIP_BN, k_pad] float32: the strips of the banded-filter planes
    ``mr``, ``mi`` [W, T] (k_pad a multiple of ``TF32_BK``), transposed so k
    is contiguous, split into TF32 parts: re_hi, re_lo, im_hi, im_lo (K1's
    PC operand)."""
    return _split_planes(*(toeplitz_strip(m[:lh, 0], bk=TF32_BK).T
                           for m in (mr, mi)))


def d_tf32(d: torch.Tensor) -> torch.Tensor:
    """[4, V128, P4] float32: the MTD matrix D [V, P] split into TF32 parts
    (re_hi, re_lo, im_hi, im_lo), zero rows up to a multiple of 128 and
    zero columns up to a multiple of 4 (K1's DFT operand)."""
    num_v, num_p = d.shape
    pad = (0, -num_p % 4, 0, -num_v % 128)
    return _split_planes(*(torch.nn.functional.pad(x, pad)
                           for x in (d.real, d.imag)))


def d_bf16(d: torch.Tensor) -> torch.Tensor:
    """[2, V, P8] bfloat16: the real and imaginary planes of the MTD matrix
    D [V, P], each value rounded once to bfloat16 (nearest even, as
    ``round_mul``), zero columns up to a multiple of 8 (TMA's 16-byte row
    stride; the bf16 DFT GEMM's A operand)."""
    pad = (0, -d.shape[1] % 8)
    return torch.stack([torch.nn.functional.pad(x, pad) for x in
                        (d.real, d.imag)]).to(torch.bfloat16).contiguous()


def make_rdm_plan(precomp, mtd_matrix, num_pulses: int, tile: int = 128,
                  lane: int = 128, *, device) -> RdmPlan:
    """Segment geometry identical to the JAX ``make_rdm_plan`` (same
    c0/r_len/pad_front/pad_tail/j_len/tile/window); constants as complex64
    tensors on ``device``."""
    g1, g2, _ = precomp.gate_splits
    n_total = precomp.n_total_gate
    fd = precomp.fir_delay
    c64 = torch.complex64
    segs = []
    c0 = g0 = 0
    for h, out_lo, out_hi in (
            (np.asarray(precomp.mf_narrow, np.complex128), fd, fd + g1),
            (np.asarray(precomp.mf_medium_win), g1, g1 + g2),
            (np.asarray(precomp.mf_long_win), g1 + g2, n_total)):
        lh = len(h)
        t = min(tile, int(2 ** np.ceil(np.log2(out_hi - out_lo))))
        t = -(-t // lane) * lane
        r0 = max(out_lo - (lh - 1), 0)
        r_len = out_hi - r0
        pad_front = (lh - 1) - (out_lo - r0)
        j_len = out_hi - out_lo
        w = t + lh - 1
        w_pad = -(-w // 128) * 128
        xlen = (-(-j_len // t) - 1) * t + w_pad
        mp = torch.as_tensor(np.pad(_banded(h, t), ((0, w_pad - w), (0, 0)))
                             ).to(device=device, dtype=c64)
        taps = torch.as_tensor(np.ascontiguousarray(h)).to(device=device,
                                                           dtype=c64)
        segs.append(RdmSegSpec(
            c0=c0, r_len=r_len, pad_front=pad_front,
            pad_tail=max(xlen - (pad_front + r_len), 0), j_len=j_len,
            g0=g0, tile=t, window=w_pad, taps=taps, mp=mp,
            strip=strip_bf16(mp.real, mp.imag, lh),
            strip_tf32=strip_tf32(mp.real, mp.imag, lh)))
        c0 += r_len
        g0 += j_len
    d = torch.as_tensor(np.asarray(mtd_matrix)).to(device=device, dtype=c64)
    return RdmPlan(segments=tuple(segs), s_compact=c0, n_gates=n_total,
                   n_dop=d.shape[0], n_pulses=num_pulses, d=d,
                   d_tf32=d_tf32(d), d_bf16=d_bf16(d))


def seed_words(frame_seed: int) -> tuple[int, int]:
    """Philox key of a frame: the low and high 32-bit words of the 64-bit
    integer frame seed (each frame of a run takes its own seed)."""
    s = int(frame_seed) & 0xFFFFFFFFFFFFFFFF
    return s & 0xFFFFFFFF, s >> 32


# ---------------------------------------------------------------- Philox

_MASK = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors holding uint32
    values, without 64-bit overflow (16-bit split of ``a``)."""
    p_lo = (a & 0xFFFF) * m                  # < 2^48
    p_hi = (a >> 16) * m                     # < 2^48
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    counter words (broadcast together); returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK
            k1 = (k1 + 0xBB67AE85) & _MASK
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform_rail(w: torch.Tensor) -> torch.Tensor:
    k24 = (w >> 8).to(torch.float32)
    return (k24 - 8388607.5) * torch.tensor(U_SCALE, dtype=torch.float32,
                                             device=w.device)


def philox_planes(plan: RdmPlan, seed: tuple[int, int], num_b: int, *,
                  device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The white (re, im) planes [B, P, xlen] f32 of every segment exactly
    as K1 draws them in draw mode (plain PyTorch integer arithmetic)."""
    i64 = torch.int64
    p = torch.arange(plan.n_pulses, dtype=i64, device=device)[None, :, None]
    b = torch.arange(num_b, dtype=i64, device=device)[:, None, None]
    out = []
    for si, seg in enumerate(plan.segments):
        n = torch.arange(seg.xlen, dtype=i64, device=device)[None, None, :]
        c3 = torch.full((), si, dtype=i64, device=device)
        w0, w1, _, _ = philox4x32_10(n, p, b, c3, seed[0], seed[1])
        keep = n >= seg.pad_front
        zero = torch.zeros((), dtype=torch.float32, device=device)
        out.append((torch.where(keep, _uniform_rail(w0), zero),
                    torch.where(keep, _uniform_rail(w1), zero)))
    return out


def strip_draw_stage_plain(plan: RdmPlan, seed: tuple[int, int], num_b: int,
                           si: int, m0: int, n0: int, *,
                           device="cpu") -> torch.Tensor:
    """Plain twin of one stage the strip GEMM's drawing producers make in
    draw mode (``csrc/band_pc_sm90.cu``, ``draw_stage``): the Xr and Xi
    boxes [2, STRIP_BN rows, STRIP_BK samples] bfloat16 of segment ``si``
    for rows m0 .. m0+127 (row = beam * P + pulse) and samples n0 ..
    n0+63, each a Philox draw keyed as ``philox_planes``'s (zeros before
    pad_front, from xlen on and past the last row) rounded to bfloat16, in
    the byte order of the 128-byte swizzle TMA writes: sample k of row r at
    position ((k // 8) ^ (r % 8)) * 8 + k % 8 of the row."""
    i64 = torch.int64
    seg = plan.segments[si]
    row = m0 + torch.arange(STRIP_BN, dtype=i64, device=device)[:, None]
    n = n0 + torch.arange(STRIP_BK, dtype=i64, device=device)[None, :]
    b, p = row // plan.n_pulses, row % plan.n_pulses
    w0, w1, _, _ = philox4x32_10(n, p, b, torch.full((), si, dtype=i64,
                                                     device=device),
                                 seed[0], seed[1])
    keep = (n >= seg.pad_front) & (n < seg.xlen) & (row < num_b * plan.n_pulses)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    box = torch.stack([torch.where(keep, _uniform_rail(w), zero)
                       for w in (w0, w1)]).to(torch.bfloat16)
    r = torch.arange(STRIP_BN, device=device)[:, None]
    k = torch.arange(STRIP_BK, device=device)[None, :]
    pos = ((k // 8) ^ (r % 8)) * 8 + k % 8
    out = torch.empty_like(box)
    out[:, r.expand_as(pos), pos] = box
    return out


def planes_from_compact(z: torch.Tensor, plan: RdmPlan,
                        dtype=torch.float32):
    """Per-segment padded planes from a compact white cube z [B, P,
    s_compact] complex (the slicing of the JAX ``noise_rdm_pallas``), as
    ``dtype`` (JAX rounds the cube to its multiply type before padding)."""
    if z.shape[2] != plan.s_compact:
        raise ValueError(f"z has {z.shape[2]} compact samples, the plan "
                         f"{plan.s_compact}")
    out = []
    for seg in plan.segments:
        piece = z[:, :, seg.c0:seg.c0 + seg.r_len]
        tail = max(seg.xlen - seg.pad_front - seg.r_len, 0)
        pad = lambda x: torch.nn.functional.pad(x, (seg.pad_front, tail))
        out.append((pad(piece.real.to(dtype).contiguous()),
                    pad(piece.imag.to(dtype).contiguous())))
    return out


def round_mul(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` as float32 (complex64 if complex) holding ``dtype`` values:
    each real plane rounded to ``dtype`` (nearest even, as JAX's
    ``astype``) and widened back. The identity for float32."""
    if x.is_complex():
        if dtype == torch.float32:
            return x
        return torch.complex(x.real.to(dtype).float(), x.imag.to(dtype).float())
    return x.float() if dtype == torch.float32 else x.to(dtype).float()


# ------------------------------------------------------- plain version


def maps_buffer(num_q: int, num_v: int, num_g: int, device) -> torch.Tensor:
    """An f32 buffer in K2's padded qvg layout (``ops/cfar_kernel.py::
    pad_maps_qvg``): [num_q, V8, HALO + G512 + HALO], V8 the Doppler rows
    rounded up to 8 and G512 the gates to ``GATE_TILE``; the interior
    [:, :V, HALO:HALO + G] left unset, the halo and the padding zero."""
    from .cfar_kernel import GATE_TILE, HALO

    v_pad = -(-num_v // 8) * 8
    g_pad = -(-num_g // GATE_TILE) * GATE_TILE + 2 * HALO
    buf = torch.empty((num_q, v_pad, g_pad), dtype=torch.float32,
                      device=device)
    buf[:, :, :HALO].zero_()
    buf[:, :, HALO + num_g:].zero_()
    buf[:, num_v:, HALO:HALO + num_g].zero_()
    return buf


def pair_maps_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's maps epilogue: the adjacent-beam sum maps
    |y_b| + |y_b+1| of a [B, V, G] complex map, each magnitude
    ``sqrt(re*re + im*im)`` rounded at every step (not ``abs``'s hypot),
    in ``maps_buffer``'s padded layout."""
    from .cfar_kernel import HALO

    num_b, num_v, num_g = y.shape
    mag = torch.sqrt(y.real * y.real + y.imag * y.imag)
    buf = maps_buffer(num_b - 1, num_v, num_g, y.device)
    buf[:, :num_v, HALO:HALO + num_g] = mag[:-1] + mag[1:]
    return buf


def noise_rdm_plain(plan: RdmPlan, l_factor: torch.Tensor, planes,
                    signal=None, *, mul_dtype=torch.float32,
                    out_dtype=torch.float32, emit_maps: bool = False):
    """Plain PyTorch version of every schedule (K1, K4, K7, K9, K10):
    banded-matmul PC per segment, MTD matrix product, Cholesky beam mix,
    rank-K signal add. ``planes``: per-segment (re, im) [B, P, >= xlen]
    (float32 or ``mul_dtype``). With ``mul_dtype`` bfloat16 the planes,
    the filter, D and L, the PC result and the MTD result are rounded to
    it (the TPU variants' rounding points, ``radar_tpu/ops/pallas_rdm.py``
    :527-536, :822-825); the output is rounded to ``out_dtype``. Returns
    [B, V, G] complex64, and with ``emit_maps`` also the pair maps of the
    unrounded map (``pair_maps_plain``). Runs on any device (the card uses
    it to check the kernels)."""
    num_b = l_factor.shape[0]
    md = mul_dtype
    pcs = []
    for seg, (xr, xi) in zip(plan.segments, planes):
        ntiles = -(-seg.j_len // seg.tile)
        x = torch.complex(round_mul(xr[:, :plan.n_pulses, :seg.xlen], md),
                          round_mul(xi[:, :plan.n_pulses, :seg.xlen], md))
        win = x.unfold(-1, seg.window, seg.tile)         # [B, P, nt, W]
        pc = torch.matmul(win, round_mul(seg.mp, md))    # [B, P, nt, T]
        pcs.append(pc.reshape(num_b, plan.n_pulses,
                              ntiles * seg.tile)[..., :seg.j_len])
    pc = round_mul(torch.cat(pcs, dim=-1), md)           # [B, P, G]
    mt = round_mul(torch.matmul(round_mul(plan.d, md), pc), md)  # [B, V, G]
    y = torch.einsum("bc,cvg->bvg", round_mul(l_factor, md), mt)
    if signal is not None:
        dv, pb, st = signal                              # [K,V] [K,G] [K,B]
        for k in range(dv.shape[0]):
            outer = dv[k][:, None] * pb[k][None, :]
            y = y + st[k][:, None, None] * outer[None]
    if emit_maps:
        return round_mul(y, out_dtype), pair_maps_plain(y)
    return round_mul(y, out_dtype)


# ------------------------------------------------------------- kernel


def _signal_args(signal, dev, num_b, num_v, num_g):
    """(K, pointers of dv, pb, st) of the rank-K signal factors for a
    kernel's epilogue; (0, null pointers) without a signal."""
    if signal is None:
        return 0, (None, None, None), ()
    dv, pb, st = (s.to(dev, torch.complex64).contiguous() for s in signal)
    num_k = dv.shape[0]
    if dv.shape != (num_k, num_v) or pb.shape != (num_k, num_g) \
            or st.shape != (num_k, num_b):
        raise ValueError("signal factors must be [K,V], [K,G], [K,B]")
    return num_k, (dv.data_ptr(), pb.data_ptr(), st.data_ptr()), (dv, pb, st)


def _kernel_planes(planes, si, seg, dev, num_b, num_p, dtype):
    """Segment ``si``'s planes as contiguous ``dtype`` [B, P, >= xlen] on
    the card: (xr, xi)."""
    xr, xi = planes[si]
    if (xr.device != dev or xr.dtype not in (torch.float32, dtype)
            or xr.shape != xi.shape or xr.dim() != 3
            or xr.shape[0] != num_b or xr.shape[1] < num_p
            or xr.shape[2] < seg.xlen):
        raise ValueError(f"planes of segment {si} must be float32 or "
                         f"{dtype} [{num_b}, >={num_p}, >={seg.xlen}] on "
                         "the card")
    # freed tensors are reused only by later work on this stream, so
    # temporaries may go out of scope before the kernel runs
    return (xr[:, :num_p].to(dtype).contiguous(),
            xi[:, :num_p].to(dtype).contiguous())


def _k1_setup(plan: RdmPlan, l_factor, signal, name: str, k1c_floats: int):
    """The checks and buffers K1, K4 and the f32 schedules share: (lib, L,
    signal arguments, p4, the scratch tensor with ``k1c_floats`` floats of
    K1c's planes first, then the PC's main and correction planes pcr, pci,
    cr, ci [B, G, P4] and the DFT's correction pass [B, V, G] complex64,
    their pointers, the output map [B, V, G], the stream)."""
    from .. import _build

    lib = _build.load("noise_rdm_sm90")
    dev = l_factor.device
    num_b, num_p = l_factor.shape[0], plan.n_pulses
    num_v, num_g = plan.n_dop, plan.n_gates
    if num_b > 16:
        raise ValueError(f"{name} mixes at most 16 beams, got {num_b}")
    for t in (l_factor, plan.d):
        if t.device != dev or t.dtype != torch.complex64:
            raise ValueError(f"{name} constants must be complex64 on the card")
    sig = _signal_args(signal, dev, num_b, num_v, num_g)
    p4 = -(-num_p // 4) * 4
    n_pc, n_map = num_b * num_g * p4, num_b * num_v * num_g
    scratch = torch.empty(k1c_floats + 4 * n_pc + 2 * n_map,
                          dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    ptrs = tuple(base + 4 * (k1c_floats + k * n_pc) for k in range(5))
    out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return (lib, l_factor.contiguous(), sig, p4, scratch, ptrs, out, stream)


def _check_strip_tf32(seg: RdmSegSpec, dev) -> torch.Tensor:
    st = seg.strip_tf32
    if st.device != dev or st.dtype != torch.float32 or st.shape[2] % TF32_BK:
        raise ValueError("the plan's strip_tf32 must be float32 "
                         f"[4, {STRIP_BN}, k * {TF32_BK}] on the card")
    return st


def _tf32_tail(lib, plan: RdmPlan, lmat, sig, p4: int, ptrs, out, stream,
               *, mix_after: bool = False, round_out: bool = False,
               maps: torch.Tensor | None = None) -> None:
    """The 3xTF32 tail on the PC's two passes. K1's and K4's: the beam mix
    of their sum, the DFT GEMM (two passes) and the sum of its passes with
    the rank-K signal into ``out``; for K1 with ``maps`` (a ``maps_buffer``)
    or ``round_out``, that sum is the epilogue that walks the beams
    (``add_maps_kernel``): it rounds ``out`` to bfloat16 values with
    ``round_out`` and writes the pair maps of the unrounded map into the
    buffer's interior. ``mix_after`` (K10, K7 and K9 at f32): the passes
    joined un-mixed, the DFT GEMM, then one epilogue that sums its passes,
    mixes the beams, adds the signal and, with ``round_out``, rounds to
    bfloat16 values."""
    global tf32_dft_launch_count, maps_launch_count
    from .. import _build

    num_b, num_p = lmat.shape[0], plan.n_pulses
    num_v, num_g = plan.n_dop, plan.n_gates
    pcr, pci, cr, ci, corr = ptrs
    num_k, sig_ptrs, _keep = sig
    _build.check(lib, lib.k1_tf32_mix(
        pcr, pci, cr, ci, None if mix_after else lmat.data_ptr(), num_b,
        num_g * p4, stream), "k1_tf32_mix")
    d4 = plan.d_tf32
    if d4.device != lmat.device or d4.shape[2] != p4:
        raise ValueError("the plan's d_tf32 must be on the card, [4, V128, "
                         f"{p4}]")
    maps_args = (None, 0, 0)
    if maps is not None:
        from .cfar_kernel import HALO

        if (mix_after or maps.device != lmat.device
                or maps.dtype != torch.float32 or not maps.is_contiguous()
                or maps.shape[0] != num_b - 1 or maps.shape[1] < num_v
                or maps.shape[2] < num_g + 2 * HALO):
            raise ValueError("K1's maps go into a maps_buffer() on the card")
        maps_args = (maps.data_ptr() + 4 * HALO, maps.shape[2],
                     maps.shape[1] * maps.shape[2])
    _build.check(lib, lib.k1_tf32_dft(
        pcr, pci, d4.data_ptr(), d4.shape[1], num_b, num_v, num_p, num_g, p4,
        *sig_ptrs, num_k, lmat.data_ptr() if mix_after else None,
        int(round_out), out.data_ptr(), corr, *maps_args, stream),
        "k1_tf32_dft")
    tf32_dft_launch_count += 1
    if not mix_after and (maps is not None or round_out):
        maps_launch_count += 1


def _k1_cuda(plan: RdmPlan, l_factor, signal, seed, planes, *,
             round_out: bool = False, emit_maps: bool = False):
    """K1 (``csrc/noise_rdm_sm90.cu``): the 3xTF32 strip-GEMM PC of every
    segment into pcT planes [B, G, P4] (a main and a correction pass, each
    one launch for all segments), the beam mix of their sum, the 3xTF32 DFT
    GEMM (two passes, the rank-K signal in the second) and their sum; in
    draw mode on the planes K1c writes first, read in place. One scratch
    allocation holds K1c's planes, the PC's planes and the DFT's
    correction. ``round_out`` rounds the map to bfloat16 values and
    ``emit_maps`` also returns its pair maps in a ``maps_buffer``, both in
    the epilogue that walks the beams."""
    global launch_count, k1c_draw_launch_count
    num_b, num_p = l_factor.shape[0], plan.n_pulses
    k1c_floats = 0 if planes is not None else _k1c_table(plan, num_b)[2]
    lib, lmat, sig, p4, scratch, ptrs, out, stream = _k1_setup(
        plan, l_factor, signal, "K1", k1c_floats)
    dev, base = lmat.device, scratch.data_ptr()
    xs, kept = [], []    # per segment (xr, xi, row stride); tensors alive
    if planes is None:
        spans = _k1c_launch(plan, seed, num_b, scratch, stream)
        k1c_draw_launch_count += 1
        if all(xlen % 4 == 0 for *_, xlen in spans):
            # K1c's [B*P, xlen] rows in place (TMA: 16-byte row strides)
            xs = [(base + 4 * r, base + 4 * i, xlen)
                  for r, i, _, xlen in spans]
        else:
            planes = _k1c_views(scratch, spans, num_b, num_p)
    if planes is not None:
        xs, kept = _tf32_rows(planes, plan, dev, num_b, num_p)
    _tf32_pc(lib, plan, xs, num_b, p4, ptrs, dev, stream)
    maps = (maps_buffer(num_b - 1, plan.n_dop, plan.n_gates, dev)
            if emit_maps else None)
    _tf32_tail(lib, plan, lmat, sig, p4, ptrs, out, stream,
               round_out=round_out, maps=maps)
    launch_count += 1
    return (out, maps) if emit_maps else out


def _tf32_pc(lib, plan: RdmPlan, xs, num_b: int, p4: int, ptrs, dev,
             stream) -> None:
    """K1's 3xTF32 strip-GEMM PC (``k1_tf32_pc``, a main and a correction
    pass, each one launch for all segments) of the planes ``xs`` (per
    segment: xr and xi pointers, row stride) into the pcT planes of
    ``ptrs``."""
    global tf32_pc_launch_count
    import ctypes

    from .. import _build

    vals = []
    for seg, (xr, xi, ld) in zip(plan.segments, xs):
        st = _check_strip_tf32(seg, dev)
        vals += [xr, xi, ld, ld, st.data_ptr(), st.shape[2], seg.j_len,
                 seg.g0]
    _build.check(lib, lib.k1_tf32_pc(
        len(plan.segments), (ctypes.c_longlong * len(vals))(*vals), num_b,
        plan.n_pulses, plan.n_gates, p4, *ptrs[:4], stream), "k1_tf32_pc")
    tf32_pc_launch_count += 1


def _tf32_rows(planes, plan: RdmPlan, dev, num_b: int, num_p: int):
    """Each segment's given planes as f32 [B*P, n] rows padded to 16 bytes:
    ([(xr pointer, xi pointer, n)], the tensors to keep alive)."""
    xs, kept = [], []
    for si, seg in enumerate(plan.segments):
        xr, xi = (_rows16(x) for x in _kernel_planes(
            planes, si, seg, dev, num_b, num_p, torch.float32))
        kept.append((xr, xi))
        xs.append((xr.data_ptr(), xi.data_ptr(), xr.shape[-1]))
    return xs, kept


def k4_table(plan: RdmPlan, xs=None) -> list:
    """K4's segment table for ``k4_tf32_pc``, 10 integers a segment: the
    planes' pointers, their columns and row stride (``xs``: per segment
    (xr, xi, columns), planes mode) or 0, 0, xlen, xlen (draw mode), the
    strip's pointer and k_pad, j_len, g0, pad_front and the segment's
    index (the Philox counter's fourth word)."""
    vals = []
    for si, seg in enumerate(plan.segments):
        xr, xi, cols = xs[si] if xs is not None else (0, 0, seg.xlen)
        st = seg.strip_tf32
        vals += [xr, xi, cols, cols, st.data_ptr(), st.shape[2], seg.j_len,
                 seg.g0, seg.pad_front, si]
    return vals


def _k4_cuda(plan: RdmPlan, l_factor, signal, seed, planes,
             beams_per_step):
    """K4 (``csrc/noise_rdm_sm90.cu``, ``k4_pc_kernel``): K1's 3xTF32
    strip-GEMM PC, both passes in one launch on each stage, the data's stage
    drawn in the block (draw mode; in planes mode loaded by TMA),
    ``beams_per_step`` beams walked a block, then K1's mix and DFT GEMM."""
    global k4_launch_count
    num_b, num_p = l_factor.shape[0], plan.n_pulses
    lib, lmat, sig, p4, scratch, ptrs, out, stream = _k1_setup(
        plan, l_factor, signal, "K4", 0)
    xs, kept = (None, ()) if planes is None else _tf32_rows(
        planes, plan, lmat.device, num_b, num_p)
    _k4_pc(lib, plan, xs, seed, num_b, p4, beams_per_step, ptrs,
           lmat.device, stream)
    _tf32_tail(lib, plan, lmat, sig, p4, ptrs, out, stream)
    k4_launch_count += 1
    return out


def _k4_pc(lib, plan: RdmPlan, xs, seed, num_b: int, p4: int,
           beams_per_step: int, ptrs, dev, stream) -> None:
    """K4's PC (``k4_tf32_pc``): K1's 3xTF32 strip GEMM, both passes in one
    launch, on the planes ``xs`` (``k4_table``) or, with ``xs`` None, on
    stages drawn in the block for ``seed``; into the pcT planes of
    ``ptrs``."""
    global k4_pc_launch_count
    import ctypes

    from .. import _build

    for seg in plan.segments:
        _check_strip_tf32(seg, dev)
    vals = k4_table(plan, xs)
    s0, s1 = seed if seed is not None else (0, 0)
    _build.check(lib, lib.k4_tf32_pc(
        len(plan.segments), (ctypes.c_longlong * len(vals))(*vals), num_b,
        plan.n_pulses, plan.n_gates, p4, beams_per_step, s0, s1,
        ctypes.c_float(U_SCALE), *ptrs[:4], stream), "k4_tf32_pc")
    k4_pc_launch_count += 1


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """Contiguous [B, P, n] as [B*P, n'] rows, n' = n padded with zero
    columns to 16 bytes (TMA's row-stride rule: 8 bf16, 4 f32)."""
    pad = -x.shape[-1] % (16 // x.element_size())
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(-1, x.shape[-1])


def strip_pc_draw(plan: RdmPlan, seed: tuple[int, int], num_b: int,
                  outr: torch.Tensor, outi: torch.Tensor) -> None:
    """Launch the strip GEMM in draw mode (``csrc/band_pc_sm90.cu``,
    ``strip_pc_kernel<true>``; K7's bf16 draw-mode PC), one launch for
    every segment: its producers draw each stage of the data (Philox keyed
    by ``seed`` as ``philox_planes``, rounded to bfloat16) and the plan's
    bf16 strips multiply it. Writes the rounded bf16 planes ``outr``,
    ``outi`` [B, P, ld] (gates g0 .. g0+j_len-1 of each segment, ld a
    multiple of 8 and at least n_gates)."""
    global strip_pc_draw_launch_count
    import ctypes

    from .. import _build

    dev = outr.device
    num_p, ld = plan.n_pulses, outr.shape[-1]
    if any(t.device != dev or t.dtype != torch.bfloat16
           or not t.is_contiguous() or tuple(t.shape) != (num_b, num_p, ld)
           for t in (outr, outi)) or ld < plan.n_gates:
        raise ValueError("strip_pc_draw writes contiguous bfloat16 planes "
                         f"[{num_b}, {num_p}, >= {plan.n_gates}] on the card")
    vals = []
    for si, seg in enumerate(plan.segments):
        check_strip(seg.strip, dev)
        vals += [seg.strip.data_ptr(), seg.strip.shape[2], seg.j_len, seg.g0,
                 seg.pad_front, seg.xlen, si]
    lib = _build.load("band_pc_sm90")
    rc = lib.sp_band_pc_draw(
        len(plan.segments), (ctypes.c_longlong * len(vals))(*vals), num_b,
        num_p, ld, seed[0], seed[1], ctypes.c_float(U_SCALE),
        outr.data_ptr(), outi.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "sp_band_pc_draw")
    strip_pc_draw_launch_count += 1


def strip_pc(segments, rows: int, num_g: int, *, out=None, outr=None,
             outi=None) -> None:
    """Launch the strip GEMM (``csrc/band_pc_sm90.cu``, ``strip_pc_kernel``)
    over up to three segments at once. ``segments``: (xr, xi, strip, j_len,
    g0) each, with xr, xi bfloat16 [rows, columns] views of a segment's
    padded sample buffer (unit column stride, a row stride that is a multiple
    of 8, 16-byte aligned) and ``strip`` its plan's [2, STRIP_BN, k_pad]
    bfloat16 strip. Writes gates g0 .. g0+j_len-1 of each row of the
    complex64 ``out`` [rows, num_g], or, rounded, of the bfloat16 planes
    ``outr``, ``outi`` [rows, num_g]."""
    bf = torch.bfloat16
    dst = (out,) if out is not None else (outr, outi)
    want = torch.complex64 if out is not None else bf
    dev = dst[0].device
    if not 1 <= len(segments) <= 3 or any(
            t is None or t.device != dev or t.dtype != want
            or not t.is_contiguous() or t.numel() != rows * num_g
            for t in dst):
        raise ValueError("strip_pc takes 1-3 segments and a contiguous "
                         f"{want} output of {rows} x {num_g} on the card")
    vals = []
    for xr, xi, strip, j_len, g0 in segments:
        _check_samples(xr, xi, rows, dev)
        check_strip(strip, dev)
        vals += [xr.data_ptr(), xi.data_ptr(), xr.shape[1], xr.stride(0),
                 strip.data_ptr(), strip.shape[2], j_len, g0]
    launch_strips(vals, rows, num_g,
                  torch.cuda.current_stream(dev).cuda_stream, out=out,
                  outr=outr, outi=outi)


def check_strip(strip: torch.Tensor, dev) -> None:
    """Raise unless ``strip`` is a bfloat16 [2, STRIP_BN, k_pad] strip on
    ``dev`` (k_pad a multiple of STRIP_BK)."""
    if (strip.device != dev or strip.dtype != torch.bfloat16
            or strip.dim() != 3 or tuple(strip.shape[:2]) != (2, STRIP_BN)
            or strip.shape[2] % STRIP_BK or not strip.is_contiguous()):
        raise ValueError(f"the strip must be bfloat16 [2, {STRIP_BN}, "
                         f"k * {STRIP_BK}] on the card")


def launch_strips(vals, rows: int, num_g: int, stream: int, *, out=None,
                  outr=None, outi=None) -> None:
    """``sp_band_pc`` on checked arguments, on ``stream``: ``vals`` holds 8
    integers a segment (the pointers of xr and xi, their columns and row
    stride, the strip's pointer and k_pad, j_len, g0), as ``strip_pc``
    builds them."""
    global strip_pc_launch_count
    import ctypes

    from .. import _build

    lib = _build.load("band_pc_sm90")
    ptr = lambda t: t.data_ptr() if t is not None else None
    rc = lib.sp_band_pc(len(vals) // 8, (ctypes.c_longlong * len(vals))(*vals),
                        rows, num_g, int(out is None), ptr(outr), ptr(outi),
                        ptr(out), stream)
    _build.check(lib, rc, "sp_band_pc")
    strip_pc_launch_count += 1


_l_rounded: dict = {}   # mul dtype -> (the latest L, its version, rounded)


def _rounded_l(l_factor: torch.Tensor, dtype) -> torch.Tensor:
    """``round_mul(l_factor, dtype)``, contiguous, kept for the latest L of
    each dtype while it is unchanged (the same tensor, held here, at the
    same version)."""
    hit = _l_rounded.get(dtype)
    if hit is not None and hit[0] is l_factor \
            and hit[1] == l_factor._version:
        return hit[2]
    val = round_mul(l_factor, dtype).contiguous()
    _l_rounded[dtype] = (l_factor, l_factor._version, val)
    return val


def dft(plan: RdmPlan, pcr, pci, num_g: int, mtr, mti) -> None:
    """Launch the bf16 DFT GEMM of K10 and K7 (``csrc/rdm_sm90.cu``,
    ``dft_kernel``): mt[b] = D @ pc[b] with the plan's rounded D
    (``d_bf16``), rounded to the bfloat16 planes ``mtr``, ``mti`` [B, V, G]
    (contiguous); ``pcr``, ``pci`` bfloat16 [B, P, ld], ld a multiple of 8
    (gates past ``num_g`` are not read)."""
    global dft_launch_count
    from .. import _build

    bf = torch.bfloat16
    d = plan.d_bf16
    dev = pcr.device
    num_b, num_p, ld = pcr.shape
    if (d.device != dev or d.dtype != bf or d.shape[:2] != (2, plan.n_dop)
            or d.shape[2] % 8 or not d.is_contiguous()):
        raise ValueError("the plan's d_bf16 must be bfloat16 [2, V, P8] on "
                         "the card")
    if (num_p != plan.n_pulses or ld % 8 or ld < num_g or any(
            t.device != dev or t.dtype != bf or not t.is_contiguous()
            or t.data_ptr() % 16 for t in (pcr, pci))
            or pci.shape != pcr.shape or any(
                t.device != dev or t.dtype != bf or not t.is_contiguous()
                or tuple(t.shape) != (num_b, plan.n_dop, num_g)
                for t in (mtr, mti))):
        raise ValueError("dft takes bfloat16 pc planes [B, P, ld] (ld a "
                         "multiple of 8, 16-byte aligned) and contiguous "
                         "bfloat16 mt planes [B, V, G] on the card")
    lib = _build.load("rdm_sm90")
    rc = lib.rs_dft(d.data_ptr(), plan.n_dop, num_p, d.shape[2],
                    pcr.data_ptr(), pci.data_ptr(), num_b, num_g, ld,
                    mtr.data_ptr(), mti.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "rs_dft")
    dft_launch_count += 1


def _check_samples(xr, xi, rows: int, dev) -> None:
    """Raise unless xr, xi are bfloat16 [rows, n] sample views on ``dev``
    with unit column stride and a row stride that is a multiple of 8,
    16-byte aligned (what the TMA maps of the PC kernels read)."""
    for x in (xr, xi):
        if (x.device != dev or x.dtype != torch.bfloat16 or x.dim() != 2
                or x.shape != xr.shape or x.stride() != xr.stride()
                or x.shape[0] != rows or x.stride(1) != 1
                or x.stride(0) % 8 or x.data_ptr() % 16):
            raise ValueError(
                "PC samples must be bfloat16 [rows, n] with a row stride "
                "that is a multiple of 8, 16-byte aligned")


def _count_schedule(schedule: str) -> None:
    """One launch of K10, K7 or K9 (``schedule``), either multiply type."""
    global k7_launch_count, k9_launch_count, k10_launch_count
    if schedule == "resident":
        k10_launch_count += 1
    elif schedule == "allbeams":
        k9_launch_count += 1
    else:
        k7_launch_count += 1


def _variant_tf32(plan: RdmPlan, l_factor, signal, seed, planes,
                  schedule: str, out_dtype):
    """K10 (``schedule="resident"``), K7 (``"stacked"``, planes or draws)
    or K9 (``"allbeams"``) at float32, on K1's 3xTF32 tensor-core GEMMs
    (``csrc/noise_rdm_sm90.cu``): K1's strip-GEMM PC of the planes (in draw
    mode K4's, its stages drawn in the block at one beam a block; both give
    K1's PC bit for bit), the two passes joined without a mix, K1's DFT
    GEMM, then the mix after the DFT, the rank-K signal and the rounding to
    ``out_dtype`` in one epilogue. The three schedules run the same
    launches, so they agree bit for bit, as the TPU's do at float32."""
    num_b, num_p = l_factor.shape[0], plan.n_pulses
    lib, lmat, sig, p4, scratch, ptrs, out, stream = _k1_setup(
        plan, l_factor, signal, f"the {schedule} schedule", 0)
    dev = lmat.device
    if planes is None:
        _k4_pc(lib, plan, None, seed, num_b, p4, 1, ptrs, dev, stream)
    else:
        xs, kept = _tf32_rows(planes, plan, dev, num_b, num_p)
        _tf32_pc(lib, plan, xs, num_b, p4, ptrs, dev, stream)
    _tf32_tail(lib, plan, lmat, sig, p4, ptrs, out, stream, mix_after=True,
               round_out=out_dtype != torch.float32)
    _count_schedule(schedule)
    return out


def _variant_bf16(plan: RdmPlan, l_factor, signal, seed, planes,
                  schedule: str, out_dtype):
    """K10 (``schedule="resident"``), K7 (``"stacked"``, planes or draws)
    or K9 (``"allbeams"``) with bfloat16 operands: the PC (the strip GEMM,
    one launch for the three segments: on planes ``strip_pc``, in draw
    mode ``strip_pc_draw``), the wgmma DFT GEMM (``dft``), then the mix."""
    from .. import _build

    lib = _build.load("rdm_variants")
    dev = l_factor.device
    num_b, num_p = l_factor.shape[0], plan.n_pulses
    num_v, num_g = plan.n_dop, plan.n_gates
    if num_b > 16:
        raise ValueError(f"the beam mix takes at most 16 beams, got {num_b}")
    for t in (l_factor, plan.d):
        if t.device != dev or t.dtype != torch.complex64:
            raise ValueError("the kernels' constants must be complex64 on "
                             "the card")
    bf = torch.bfloat16
    lmat = _rounded_l(l_factor, bf)
    num_k, sig_ptrs, _keep = _signal_args(signal, dev, num_b, num_v, num_g)
    # the DFT GEMM reads pc by TMA: rows padded to 16 bytes
    ld = -(-num_g // 8) * 8
    pcr = torch.empty((num_b, num_p, ld), dtype=bf, device=dev)
    pci = torch.empty_like(pcr)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if planes is not None:
        segs = []
        for si, seg in enumerate(plan.segments):
            xr, xi = _kernel_planes(planes, si, seg, dev, num_b, num_p, bf)
            segs.append((_rows16(xr), _rows16(xi), seg.strip, seg.j_len,
                         seg.g0))
        strip_pc(segs, num_b * num_p, ld, outr=pcr, outi=pci)
    else:
        strip_pc_draw(plan, seed, num_b, pcr, pci)
    out = torch.empty((num_b, num_v, num_g), dtype=torch.complex64,
                      device=dev)
    mtr = torch.empty((num_b, num_v, num_g), dtype=bf, device=dev)
    mti = torch.empty_like(mtr)
    dft(plan, pcr, pci, num_g, mtr, mti)
    _build.check(lib, lib.rv_mix(mtr.data_ptr(), mti.data_ptr(),
                                 lmat.data_ptr(), num_b, num_v, num_g,
                                 *sig_ptrs, num_k,
                                 int(out_dtype != torch.float32),
                                 out.data_ptr(), stream), "rv_mix")
    _count_schedule(schedule)
    return out


_DTYPES = (torch.float32, torch.bfloat16)


def _check_schedule(planes, rolling, beams_per_step, variant, stacked,
                    mul_dtype, out_dtype) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if mul_dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError("mul_dtype and out_dtype are torch.float32 or "
                         "torch.bfloat16")
    if planes is None and variant != "beams":
        raise ValueError(f"variant={variant!r} is a planes-mode schedule; "
                         "draw mode takes stacked=True or rolling=False")
    if stacked:
        if planes is not None:
            raise ValueError("stacked=True is the draw-mode option; planes "
                             "mode takes variant='stacked'")
        if not rolling:
            raise ValueError("stacked=True requires rolling=True")
    if variant in ("stacked", "allbeams") and out_dtype != torch.float32:
        # as radar_tpu/ops/pallas_rdm.py:760-765: these schedules write f32
        raise ValueError(f"variant {variant!r} implements float32 output "
                         "only")
    if variant == "beams" and not stacked and (
            mul_dtype != torch.float32
            or (out_dtype != torch.float32 and not rolling)):
        raise NotImplementedError(
            "variant='beams' (K1, and K4 with rolling=False) multiplies in "
            "float32 only, and K4 writes float32 only: bfloat16 operands "
            "run in the variants 'resident', 'stacked', 'allbeams' and in "
            "draw mode with stacked=True; K1 takes "
            "out_dtype=torch.bfloat16")
    if rolling:
        if beams_per_step is not None:
            raise ValueError("beams_per_step= sets the schedule of "
                             "rolling=False")


def noise_rdm(plan: RdmPlan, l_factor: torch.Tensor, signal=None, *,
              seed: tuple[int, int] | None = None, planes=None,
              layout: str = "vgb", rolling: bool = True,
              beams_per_step: int | None = None, variant: str = "beams",
              stacked: bool = False, mul_dtype=torch.float32,
              out_dtype=torch.float32, emit_maps: bool = False):
    """Complete noise (+ signal) RDM: draw mode with ``seed`` (two uint32
    key words, see ``seed_words``) or planes mode with ``planes``.

    ``l_factor`` [B, B] complex64 decides the device: a CUDA tensor runs
    the kernel (or raises), a CPU tensor the plain version. ``rolling``
    (the default) runs K1; ``rolling=False`` runs K4, the schedule of the
    TPU's non-rolling kernel, with ``beams_per_step`` beams per block
    (default 1; any value gives the same draws, keyed by the true beam).
    ``layout="bvg"`` returns the native [B, V, G]; ``"vgb"`` the [V, G, B]
    view.

    ``variant`` (planes mode) picks the schedule of the TPU's planes
    kernel: ``"beams"`` (K1), ``"resident"`` (K10), ``"stacked"`` (K7),
    ``"allbeams"`` (K9); ``stacked=True`` (draw mode) runs K7 on K1's
    draws. These take ``mul_dtype`` float32 or bfloat16; ``out_dtype``
    bfloat16 rounds the output of ``"resident"`` and of ``stacked=True``
    (``"stacked"``/``"allbeams"`` raise ``ValueError`` as JAX does). K1 and
    K4 multiply in float32 only and raise ``NotImplementedError`` for
    bfloat16 operands; K1 takes ``out_dtype`` bfloat16 (its map rounded
    to bfloat16 values, ``cfg.kernel_out_bf16``), K4 raises for it.

    ``emit_maps`` (K1 with a ``signal``: ``cfg.kernel_maps``) returns
    ``(rdm, maps)``: ``maps`` are the adjacent-beam sum maps |y_b| +
    |y_b+1| of the unrounded map in K2's padded qvg layout
    (``maps_buffer``; interior ``[:, :V, HALO:HALO + G]``), written by the
    epilogue that walks the beams, as the TPU's kernel writes them from its
    resident f32 tiles."""
    if (seed is None) == (planes is None):
        raise ValueError("give exactly one of seed= and planes=")
    if layout not in ("vgb", "bvg"):
        raise ValueError(f"unknown layout {layout!r}")
    _check_schedule(planes, rolling, beams_per_step, variant, stacked,
                    mul_dtype, out_dtype)
    if emit_maps and (signal is None or not rolling or variant != "beams"
                      or stacked):
        raise ValueError("emit_maps is K1's mode on the signal-fused map: "
                         "give signal=, rolling=True, variant='beams'")
    num_b = l_factor.shape[0]
    if not rolling:
        beams_per_step = 1 if beams_per_step is None else beams_per_step
        if not 1 <= beams_per_step <= num_b:
            raise ValueError(f"beams_per_step={beams_per_step} is not in "
                             f"[1, {num_b}]")
    schedule = "stacked" if stacked else variant
    if l_factor.is_cuda:
        if schedule == "beams" and rolling:
            bm = _k1_cuda(plan, l_factor, signal, seed, planes,
                          round_out=out_dtype != torch.float32,
                          emit_maps=emit_maps)
        elif schedule == "beams":
            bm = _k4_cuda(plan, l_factor, signal, seed, planes,
                          beams_per_step)
        else:
            variant_cuda = (_variant_tf32 if mul_dtype == torch.float32
                            else _variant_bf16)
            bm = variant_cuda(plan, l_factor, signal, seed, planes, schedule,
                              out_dtype)
    else:
        if planes is None:
            planes = philox_planes(plan, seed, num_b, device=l_factor.device)
        bm = noise_rdm_plain(plan, l_factor, planes, signal,
                             mul_dtype=mul_dtype, out_dtype=out_dtype,
                             emit_maps=emit_maps)
    if emit_maps:
        bm, maps = bm
        return (bm if layout == "bvg" else bm.permute(1, 2, 0)), maps
    return bm if layout == "bvg" else bm.permute(1, 2, 0)


def noise_rdm_compact(z: torch.Tensor, plan: RdmPlan,
                      l_factor: torch.Tensor, *, variant: str = "beams",
                      mul_dtype=torch.float32,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Noise RDM [V, G, B] of a compact white cube z [B, P, s_compact]
    complex: the per-segment planes of ``planes_from_compact``, rounded to
    ``mul_dtype``, through the planes kernel's ``variant`` (port of
    ``radar_tpu/ops/pallas_rdm.py::noise_rdm_pallas``, the A/B entry point
    of the TPU's schedules)."""
    return noise_rdm(plan, l_factor,
                     planes=planes_from_compact(z, plan, mul_dtype),
                     variant=variant, mul_dtype=mul_dtype,
                     out_dtype=out_dtype)


# ------------------------------------------------------------ K1c


def k1c_layout(plan: RdmPlan, num_b: int):
    """K1c's one allocation: ``(table, spans, floats)``, where ``table``
    holds per segment ``pad_front, xlen`` and the float offsets of its re
    and im planes (each on a 256-byte boundary), ``spans`` per segment
    ``(re offset, im offset, plane size, xlen)`` and ``floats`` the
    allocation's length."""
    table, spans, off = [], [], 0
    for seg in plan.segments:
        size = num_b * plan.n_pulses * seg.xlen
        step = -(-size // 64) * 64
        table += [seg.pad_front, seg.xlen, off, off + step]
        spans.append((off, off + step, size, seg.xlen))
        off += 2 * step
    return table, spans, off


_k1c_tables: dict = {}       # K1c's segment table per plane geometry


def _gen_planes_cuda(plan: RdmPlan, seed, num_b: int, device):
    """K1c: one launch writes every segment's planes into one allocation;
    the planes are views of it."""
    global k1c_launch_count
    buf = torch.empty(_k1c_table(plan, num_b)[2], dtype=torch.float32,
                      device=device)
    spans = _k1c_launch(plan, seed, num_b, buf,
                        torch.cuda.current_stream(device).cuda_stream)
    k1c_launch_count += 1
    return _k1c_views(buf, spans, num_b, plan.n_pulses)


def _k1c_table(plan: RdmPlan, num_b: int):
    """``k1c_layout`` with its table as a ctypes array, kept per plane
    geometry."""
    import ctypes

    geom = (num_b, plan.n_pulses,
            tuple((sg.pad_front, sg.xlen) for sg in plan.segments))
    if geom not in _k1c_tables:
        table, spans, floats = k1c_layout(plan, num_b)
        _k1c_tables[geom] = ((ctypes.c_longlong * len(table))(*table),
                             spans, floats)
    return _k1c_tables[geom]


def _k1c_launch(plan: RdmPlan, seed, num_b: int, buf: torch.Tensor,
                stream: int):
    """K1c's launch (``k1c_planes``) into the f32 ``buf`` from its first
    float, uncounted here (``gen_noise_planes`` counts it in
    ``k1c_launch_count``, K1's draw mode in ``k1c_draw_launch_count``): the
    spans of ``k1c_layout``."""
    import ctypes

    from .. import _build

    lib = _build.load("noise_rdm")
    table, spans, floats = _k1c_table(plan, num_b)
    if buf.dtype != torch.float32 or buf.numel() < floats:
        raise ValueError(f"K1c writes {floats} float32 values")
    rc = lib.k1c_planes(table, len(spans), seed[0], seed[1],
                        ctypes.c_float(U_SCALE), num_b, plan.n_pulses,
                        buf.data_ptr(), stream)
    _build.check(lib, rc, "k1c_planes")
    return spans


def _k1c_views(buf: torch.Tensor, spans, num_b: int, num_p: int):
    """The (re, im) planes [B, P, xlen] of each segment in K1c's ``buf``."""
    plane = lambda off, xlen: buf.as_strided(
        (num_b, num_p, xlen), (num_p * xlen, xlen, 1), off)
    return [(plane(r, xlen), plane(i, xlen)) for r, i, _, xlen in spans]


def gen_noise_planes(plan: RdmPlan, seed: tuple[int, int], num_b: int, *,
                     device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The white (re, im) planes [B, P, xlen] f32 of every segment that
    draw mode draws for ``seed`` — port of ``radar_tpu/ops/pallas_rdm.py::
    gen_noise_planes_pallas``, so planes mode can be fed draw mode's noise
    (``noise_rdm(planes=gen_noise_planes(...))`` equals ``noise_rdm(seed=
    ...)`` bit for bit). The port's plane layout is its own: [B, P, xlen]
    with no pulse-pad rows and no tail beyond the samples a window reads.

    On a CUDA device kernel K1c writes them; on the CPU its plain version
    ``philox_planes`` does, with the same bits."""
    device = torch.device(device)
    if device.type == "cuda":
        return _gen_planes_cuda(plan, seed, num_b, device)
    return philox_planes(plan, seed, num_b, device=device)
