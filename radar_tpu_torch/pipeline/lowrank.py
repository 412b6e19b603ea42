"""Stages of the rank-K closed-form RDM pipeline — port of
``radar_tpu/pipeline/lowrank.py:46-239``.

Pulse compression acts on fast time, the MTD on slow time and the beam
mix on beams, so they commute: the deterministic signal RDM is K outer
products of pulse-compressed base rows, Doppler-transformed phasor rows
and mixed steering rows, and the noise goes through PC and MTD un-mixed,
with the Cholesky beam mix applied afterwards. ``noise_rdm_sig`` computes
the complete map in kernel K1 (``ops/noise_rdm.py``); ``signal_rdm``,
``pc``, ``mtd`` and ``mix_add`` are the plain PyTorch stages the JAX XLA
chain has, used to hold the port against it.

Frame seeds. Where the JAX path folds a ``jax.random`` key into two seed
words, the port takes an explicit integer seed per frame; its low and
high 32-bit words key the kernel's Philox stream
(``ops/noise_rdm.py::seed_words``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config.params import RadarConfig
from ..ops.dbf import dbf_weights_effective_np
from ..ops.mtd import make_mtd_matrix, mtd_matmul
from ..ops.noise_rdm import RdmPlan, make_rdm_plan, noise_rdm, seed_words
from ..ops.pulse_compression import (compact_noise_plan, make_matmul_plan,
                                     pulse_compress_matmul, to_device)
from ..sim.echo import beam_noise_factor, synthesize_factors


class LowrankStages(NamedTuple):
    signal_factors: Callable  # targets -> (dop_v [K,V], pc_base [K,G], steer_b [K,B])
    signal_rdm: Callable      # targets -> [V, G, B] (or [B, V, G]) complex
    pc: Callable              # compact white z [P, S_c, B] -> [P, G, B]
    mtd: Callable             # [P, G, B] -> [V, G, B]
    mix_add: Callable         # (rdm_sig, rdm_z) -> final RDM [V, G, B]
    noise_rdm_sig: Callable   # (frame_seed, targets, layout, planes) -> RDM
    rplan: RdmPlan
    l_factor: torch.Tensor    # [B, B] complex64 Cholesky beam mix


def check_config(cfg: RadarConfig) -> None:
    """Refuse the noise-RDM variants the port does not run."""
    if cfg.noise_rdm_impl != "pallas_prng":
        raise NotImplementedError(
            f"cfg.noise_rdm_impl={cfg.noise_rdm_impl!r} is not ported: the "
            "port draws the noise inside kernel K1 ('pallas_prng')")
    for flag in ("pc_method", "mtd_method"):
        if getattr(cfg, flag) != "matmul":
            raise NotImplementedError(
                f"cfg.{flag}={getattr(cfg, flag)!r} is not ported (the "
                "in-kernel noise RDM needs the matmul plans)")
    if cfg.mtd_fft_len is not None:
        raise NotImplementedError(
            f"cfg.mtd_fft_len={cfg.mtd_fft_len!r} is not ported")
    if cfg.kernel_out_bf16:
        raise NotImplementedError("cfg.kernel_out_bf16=True is not ported")
    if cfg.noise_dist != "uniform":
        raise ValueError("noise_rdm_impl='pallas_prng' implements uniform "
                         "rails only; set noise_dist='uniform'")


def make_lowrank_stages(cfg: RadarConfig, precomp, *,
                        device) -> LowrankStages:
    check_config(cfg)
    prec = cfg.matmul_precision
    c64 = torch.complex64
    w_eff = dbf_weights_effective_np(np.asarray(precomp.dbf_w),
                                     cfg.dbf_variant)
    mix_np = np.ascontiguousarray(w_eff.T)                  # [C, B]
    l_t = torch.as_tensor(beam_noise_factor(w_eff)).to(device=device,
                                                       dtype=c64)
    mplan_np = make_matmul_plan(precomp)
    mplan = to_device(mplan_np, device)
    nplan = to_device(compact_noise_plan(mplan_np)[0], device)
    mtd_np = make_mtd_matrix(precomp.mtd_win, cfg.sig.prt_num,
                             cfg.mtd_fft_len)
    mtd_t = torch.as_tensor(mtd_np).to(device=device, dtype=c64)
    rplan = make_rdm_plan(precomp, mtd_np, cfg.sig.prt_num, tile=128,
                          lane=128, device=device)

    def signal_factors(targets):
        dop_amp, base, steer_b = synthesize_factors(targets, precomp, cfg,
                                                    mix_np, device=device)
        pc_base = pulse_compress_matmul(base[:, :, None], mplan,
                                        precision=prec)[:, :, 0]  # [K, G]
        dop_v = mtd_matmul(dop_amp.T[:, None, :], mtd_t,
                           precision=prec)[:, 0, :].T             # [K, V]
        return dop_v, pc_base, steer_b

    def signal_rdm(targets, layout="vgb"):
        dop_v, pc_base, steer_b = signal_factors(targets)
        spec = "kv,kj,kb->bvj" if layout == "bvg" else "kv,kj,kb->vjb"
        return torch.einsum(spec, dop_v, pc_base, steer_b)

    def pc(z):
        return pulse_compress_matmul(z, nplan, precision=prec)

    def mtd(x):
        return mtd_matmul(x, mtd_t, precision=prec)

    def mix_add(rdm_sig, rdm_z):
        return rdm_sig + torch.einsum("vgj,bj->vgb", rdm_z, l_t)

    def noise_rdm_sig(frame_seed, targets, layout="vgb", planes=None):
        return noise_rdm(rplan, l_t, signal_factors(targets),
                         seed=None if planes is not None
                         else seed_words(frame_seed),
                         planes=planes, layout=layout)

    return LowrankStages(signal_factors=signal_factors,
                         signal_rdm=signal_rdm, pc=pc, mtd=mtd,
                         mix_add=mix_add, noise_rdm_sig=noise_rdm_sig,
                         rplan=rplan, l_factor=l_t)
