"""The range-Doppler map of a frame or a trial, in plain PyTorch.

Complex128 on any device, after the upstream MATLAB chain
(``fun_process_single_frame.m:81-136``): rank-K echo synthesis, AWGN,
DBF (y = x @ W^H), the three-segment pulse compression as causal
convolutions by FFT, and the MTD (Kaiser window, DFT over pulses,
fftshift) as one matrix product.

``prec`` names the arithmetic: "f64" is the reference; "tf32" rounds every
operand of each linear stage (DBF, PC, MTD) to TF32 and multiplies in
float64: the control a step below float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .consts import Radar

C128 = torch.complex128


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float64 values rounded to TF32 (10 stored mantissa bits, nearest
    even), through float32."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32).to(torch.float64)


def lowp(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` (complex128) with each rail rounded to ``prec``."""
    if prec == "f64":
        return x
    rnd = {"tf32": _round_tf32}[prec]
    if not x.is_complex():
        return rnd(x.to(torch.float64))
    return torch.complex(rnd(x.real), rnd(x.imag))


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(C128)


def echo_beams(r: Radar, targets, device, prec: str = "f64"
               ) -> torch.Tensor:
    """Noise-free beam cube [P, S, B]: each target's delayed Tx pulse,
    Doppler phasor, amplitude and channel steering (v8_3's echo model),
    through the DBF."""
    sig = r.conf["sig"]
    n = np.arange(r.num_c)
    cube = torch.zeros((r.num_p, r.num_s, r.num_b), dtype=C128,
                       device=device)
    w = lowp(_t(np.conj(r.dbf_w), device), prec)              # [B, C]
    for rng, vel, el, snr in zip(*(np.atleast_1d(np.asarray(f, np.float64))
                                   for f in targets)):
        delay = int(np.round(2 * rng / sig["c"] * sig["fs"]))
        base = np.zeros(r.num_s, np.complex128)
        if 0 < delay < r.num_s:
            base[delay:] = r.tx[:r.num_s - delay]
        fd = 2 * vel / r.wavelength
        dop = np.exp(2j * np.pi * fd * np.arange(r.num_p) * sig["prt"])
        amp = np.sqrt(10 ** (snr / 10) / r.p_signal)
        dphi = (2 * np.pi * r.conf["array"]["element_spacing"]
                * np.sin(np.deg2rad(el)) / r.wavelength)
        steer = lowp(_t(np.exp(1j * n * dphi), device), prec)     # [C]
        steer_b = w @ steer                                       # [B]
        cube += (_t(amp * dop, device)[:, None, None]
                 * _t(base, device)[None, :, None] * steer_b[None, None, :])
    return cube


def channel_noise(seed: int, shape, device) -> torch.Tensor:
    """The frame's AWGN [P, S, C], CN(0, 1) a cell: ``torch.randn`` from a
    ``torch.Generator`` on ``device`` seeded with the frame seed mod 2^64,
    the draw the seed stands for."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return torch.randn(tuple(shape), dtype=torch.complex64, generator=g,
                       device=device)


def dbf_noise(r: Radar, seed: int, device, prec: str = "f64",
              chunk: int = 64) -> torch.Tensor:
    """The AWGN of frame seed ``seed`` through the DBF: [P, S, B]."""
    z = channel_noise(seed, (r.num_p, r.num_s, r.num_c), device)
    w = lowp(_t(np.conj(r.dbf_w), device), prec)
    out = torch.empty((r.num_p, r.num_s, r.num_b), dtype=C128, device=device)
    for p0 in range(0, r.num_p, chunk):
        x = lowp(z[p0:p0 + chunk].to(C128), prec)
        out[p0:p0 + chunk] = torch.einsum("psc,bc->psb", x, w)
    del z
    return out


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def causal_conv(x: torch.Tensor, h: torch.Tensor, lo: int,
                hi: int) -> torch.Tensor:
    """Output columns [lo, hi) of the causal convolution of x (last axis,
    zero past its end) with h: y[n] = sum_k h[k] x[n - k]."""
    need = min(hi, x.shape[-1])
    nfft = _next_pow2(hi + len(h))
    y = torch.fft.ifft(torch.fft.fft(x[..., :need], n=nfft)
                       * torch.fft.fft(h, n=nfft), n=nfft)
    return y[..., lo:hi]


def pulse_compress(r: Radar, beams: torch.Tensor, prec: str = "f64"
                   ) -> torch.Tensor:
    """[P, S, B] -> [P, G, B]: each segment's matched filter on the samples
    from its start, spliced by global gate."""
    x = lowp(beams, prec).transpose(1, 2)                     # [P, B, S]
    out = []
    for seg in r.segments:
        h = lowp(_t(seg.h, x.device), prec)
        out.append(causal_conv(x[..., seg.start:], h, seg.lo, seg.hi))
    return torch.cat(out, dim=-1).transpose(1, 2)


def mtd_matrix(r: Radar, device, prec: str = "f64") -> torch.Tensor:
    """[V, P]: Kaiser window, DFT over the pulses, fftshift of the bins."""
    p, v = np.arange(r.num_p), np.arange(r.num_v)
    m = np.exp(-2j * np.pi * np.outer(v, p) / r.num_v) * r.mtd_win[None, :]
    return lowp(_t(np.fft.fftshift(m, axes=0), device), prec)


def mtd(r: Radar, pc: torch.Tensor, prec: str = "f64") -> torch.Tensor:
    """[P, G, B] -> [V, G, B]."""
    d = mtd_matrix(r, pc.device, prec)
    x = lowp(pc, prec)
    return (d @ x.reshape(r.num_p, -1)).reshape(r.num_v, *pc.shape[1:])


def exact_rdm(r: Radar, targets, seed: int, device, prec: str = "f64"
              ) -> torch.Tensor:
    """The exact stream's map [V, G, B] of one frame or trial: echo plus
    the frame seed's channel AWGN, DBF, PC, MTD."""
    beams = echo_beams(r, targets, device, prec)
    beams += dbf_noise(r, seed, device, prec)
    pc = pulse_compress(r, beams, prec)
    del beams
    return mtd(r, pc, prec)

