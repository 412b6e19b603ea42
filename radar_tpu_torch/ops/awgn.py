"""Complex AWGN added to a complex64 cube: kernel K5 — port of
``radar_tpu/ops/pallas_noise.py`` (``add_noise_pallas``, body
``_awgn_kernel``), the ``noise_impl="pallas"`` AWGN of the reference stream.

``awgn`` runs ``csrc/awgn.cu`` for a CUDA tensor (or raises) and the plain
PyTorch version ``awgn_plain`` only for a CPU tensor. Both compute

  y = x + (r cos(theta), r sin(theta)),  r = sqrt(-2 log(u1)) * sigma,
  u1 = (k1 + 0.5) * 2^-24,  theta = (2 pi 2^-24) * k2,  sigma = sqrt(p/2)

from 24-bit integers ``k = w >> 8`` of Philox4x32-10 words: the counter of
draw pair i (complex samples 2i, 2i+1 of the flattened cube) is
``(lo32(i), hi32(i), 0, AWGN_TAG)`` under the frame's two seed words
(``ops/noise_rdm.py::seed_words``). K1 puts a segment index 0..2 in the
last counter word, so the two kernels never draw the same stream. The
uniforms agree bit for bit between kernel and plain version; the outputs
differ by the ulps of log/sin/cos. Like the TPU's hardware generator, this
does not reproduce JAX's bits: the contract is statistical (rails i.i.d.
N(0, p_noise/2)).
"""

from __future__ import annotations

import numpy as np
import torch

from .noise_rdm import philox4x32_10

AWGN_TAG = 0x4157474E                 # "AWGN": last Philox counter word
THETA_SCALE = float(np.float32(2.0 * np.pi * 2.0 ** -24))

launch_count = 0                      # K5 launches


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.complex64:
        raise ValueError(f"AWGN is complex64-only, got {x.dtype}")


def _sigma(p_noise: float) -> float:
    return float(np.float32(np.sqrt(p_noise / 2.0)))


def awgn_plain(x: torch.Tensor, seed: tuple[int, int],
               p_noise: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K5 (Philox in int64 torch arithmetic,
    Box-Muller in f32). Runs on any device (the card uses it to check
    K5)."""
    _check(x)
    n = x.numel()
    dev = x.device
    i = torch.arange((n + 1) // 2, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    tag = torch.full((), AWGN_TAG, dtype=torch.int64, device=dev)
    w0, w1, w2, w3 = philox4x32_10(i & 0xFFFFFFFF, i >> 32, zero, tag,
                                   seed[0], seed[1])
    a = torch.stack((w0, w2), 1).reshape(-1)[:n]
    b = torch.stack((w1, w3), 1).reshape(-1)[:n]
    u1 = ((a >> 8).to(torch.float32) + 0.5) * 2.0 ** -24
    theta = (b >> 8).to(torch.float32) * THETA_SCALE
    r = torch.sqrt(-2.0 * torch.log(u1)) * _sigma(p_noise)
    flat = x.reshape(-1)
    return torch.complex(flat.real + r * torch.cos(theta),
                         flat.imag + r * torch.sin(theta)).reshape(x.shape)


def _awgn_cuda(x: torch.Tensor, seed, p_noise: float) -> torch.Tensor:
    global launch_count
    from .. import _build

    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("K5 takes a contiguous, 16-byte aligned complex64 "
                         "tensor")
    lib = _build.load("awgn")
    y = torch.empty_like(x)
    code = lib.k5_awgn(x.data_ptr(), y.data_ptr(), x.numel(),
                       seed[0], seed[1], _sigma(p_noise), THETA_SCALE,
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "k5_awgn")
    launch_count += 1
    return y


def awgn(x: torch.Tensor, seed: tuple[int, int],
         p_noise: float = 1.0) -> torch.Tensor:
    """``x + complex AWGN`` (per-rail std sqrt(p_noise/2)) as a new
    tensor, for complex64 ``x`` of any shape; ``seed`` is two uint32 key
    words. K5 for a CUDA tensor (or it raises), the plain version for a
    CPU tensor."""
    _check(x)
    if x.is_cuda:
        return _awgn_cuda(x, seed, p_noise)
    return awgn_plain(x, seed, p_noise)
