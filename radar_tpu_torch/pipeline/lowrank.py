"""Stages of the rank-K closed-form RDM pipeline — port of
``radar_tpu/pipeline/lowrank.py``.

Pulse compression acts on fast time, the MTD on slow time and the beam
mix on beams, so they commute: the deterministic signal RDM is K outer
products of pulse-compressed base rows, Doppler-transformed phasor rows
and mixed steering rows, and the noise goes through PC and MTD un-mixed,
with the Cholesky beam mix applied afterwards. Three noise-RDM backends
(``cfg.noise_rdm_impl``):

- ``"xla"``: the plain chain ``mix_add(signal_rdm, mtd(pc(gen_noise)))``
  (white CN(0,1) noise from a ``torch.Generator``, compact or the full PRT
  under ``compact_noise=False``; matrix products, or FFTs for
  ``pc_method``/``mtd_method="fft"``). JAX leaves this chain to XLA, the
  port to cuBLAS/cuFFT.
- ``"pallas"``: white planes drawn per segment by a ``torch.Generator``
  (``noise_dist="normal"``: N(0,1)·√½ rails; ``"uniform"``: U[−√1.5, √1.5)),
  zero before ``pad_front``, through kernel K1's planes mode.
- ``"pallas_prng"``: K1 draws the noise itself (Philox). The frame runs
  it with the rank-K signal fused (``noise_rdm_sig``); the Monte-Carlo
  trials run it noise-only (``noise_rdm``) on a signal RDM made once per
  SNR point.

Every route takes ``cfg.mtd_fft_len``: D is [V, P] with V Doppler bins
from P pulses (the reference's zero-padded v7_7 MTD, 512 points), and
the kernels take V as they take P. A kernel route needs the matmul PC
plan and the MTD matrix, and raises JAX's ``ValueError`` without them.

The kernel routes take JAX's effective dtypes (``route_dtypes``). On the
card they are those JAX runs on its accelerator: K1 multiplies in bf16 (the
TPU kernel's own operands: planes, filter, D and L rounded, the PC and the
DFT rounded, the mix after the DFT, the signal in f32), the noise-only map
(the trials') and the "pallas" route's map are rounded to bf16 values, the
"pallas" route's drawn planes are rounded to bf16, and the signal-fused map
(``noise_rdm_sig``, the frame's) is f32 unless ``cfg.kernel_out_bf16``. On
the CPU they are interpret mode's: f32 throughout, with
``cfg.kernel_out_bf16`` honoured. ``accelerator_dtypes=False`` runs the
card in interpret mode's dtypes (K1's f32 kernels, its 3xTF32 GEMMs);
``True`` runs the plain versions on the CPU in the accelerator's.
``emit_maps=True`` (``cfg.kernel_maps``) also returns K1's pair maps.
``cfg.noise_prng`` ("threefry"/"rbg") selects nothing here: every draw comes from the torch generator or K1's Philox; JAX's
streams cannot be reproduced anyway, so tests inject the same noise into
both packages.

Frame seeds. Where the JAX path takes a ``jax.random`` key, the port takes
an integer seed per frame: it seeds the ``torch.Generator`` of the xla and
pallas draws, and its low and high 32-bit words key K1's Philox stream
(``ops/noise_rdm.py::seed_words``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config.params import RadarConfig
from ..ops.dbf import dbf_weights_effective_np
from ..ops.mtd import make_mtd_matrix, mtd, mtd_matmul
from ..ops.noise_rdm import (A_UNIF, RdmPlan, make_rdm_plan, noise_rdm,
                              seed_words)
from ..ops.pulse_compression import (compact_noise_plan, make_matmul_plan,
                                     make_plan, pulse_compress,
                                     pulse_compress_matmul, to_device)
from ..sim.echo import (beam_noise_factor, seeded_generator,
                        synthesize_factors, white_complex_noise)

IMPLS = ("xla", "pallas", "pallas_prng")
ROOT2INV = float(np.float32(np.sqrt(0.5)))


class RouteDtypes(NamedTuple):
    """The kernel routes' dtypes, as ``torch`` dtypes."""
    mul: torch.dtype         # K1's multiply type (JAX's mul_dtype)
    noise_out: torch.dtype   # the noise-only map (noise_rdm, noisy_rdm)
    sig_out: torch.dtype     # the signal-fused map (noise_rdm_sig)
    planes: torch.dtype      # the "pallas" route's drawn planes


def route_dtypes(cfg: RadarConfig, accelerator: bool) -> RouteDtypes:
    """JAX's effective dtypes of the kernel routes. On its accelerator
    (``accelerator``: the port's CUDA device) every K1 call multiplies in
    bf16, the noise-only map is bf16 (``radar_tpu/pipeline/lowrank.py``
    :143-148), the signal-fused map f32 unless ``cfg.kernel_out_bf16``
    (:166-171), and the "pallas" route draws bf16 planes and writes a bf16
    map (:209-218, :228-231). Interpret mode (the CPU) takes f32
    throughout, ``cfg.kernel_out_bf16`` honoured (:170-171)."""
    low = torch.bfloat16 if accelerator else torch.float32
    sig_out = torch.bfloat16 if cfg.kernel_out_bf16 else torch.float32
    return RouteDtypes(mul=low, noise_out=low, sig_out=sig_out, planes=low)


class LowrankStages(NamedTuple):
    impl: str                 # cfg.noise_rdm_impl
    rdm_layout: str           # layout of the route's RDM: "bvg" (kernels), "vgb"
    signal_factors: Callable  # targets -> (dop_v [K,V], pc_base [K,G], steer_b [K,B])
    signal_rdm: Callable      # (targets, layout) -> [V, G, B] or [B, V, G]
    gen_noise: Callable       # frame_seed -> white z [P, S(_compact), B]
    pc: Callable              # z [P, S(_compact), B] -> [P, G, B]
    mtd: Callable             # [P, G, B] -> [V, G, B]
    mix_add: Callable         # (rdm_sig, rdm_z) -> final RDM [V, G, B]
    noisy_rdm: Callable       # (rdm_sig, frame_seed, noise, noise_planes) -> RDM
    # kernel routes only (None on "xla"):
    noise_rdm: Callable | None      # (frame_seed, layout, planes) -> noise RDM
    noise_planes: Callable | None   # "pallas": frame_seed -> per-segment planes
    noise_rdm_sig: Callable | None  # "pallas_prng": (seed, targets, layout,
                                    # planes, emit_maps)
    rplan: RdmPlan | None
    l_factor: torch.Tensor    # [B, B] complex64 Cholesky beam mix
    dtypes: RouteDtypes       # the kernel routes' dtypes


def check_config(cfg: RadarConfig) -> None:
    """Refuse what the rank-K stream does not run."""
    if cfg.noise_rdm_impl not in IMPLS:
        raise ValueError(f"cfg.noise_rdm_impl={cfg.noise_rdm_impl!r}: not "
                         f"one of {IMPLS}")
    if cfg.noise_rdm_impl != "xla" and (cfg.pc_method, cfg.mtd_method) != (
            "matmul", "matmul"):
        # as JAX refuses it (radar_tpu/pipeline/lowrank.py:93-104)
        raise ValueError(
            f"noise_rdm_impl={cfg.noise_rdm_impl!r} requires the matmul PC "
            "plan and the MTD matrix (pc_method='matmul' and "
            f"mtd_method='matmul'); got pc_method={cfg.pc_method!r}, "
            f"mtd_method={cfg.mtd_method!r}")
    if cfg.noise_dist not in ("normal", "uniform"):
        raise ValueError(f"cfg.noise_dist={cfg.noise_dist!r}: not one of "
                         "('normal', 'uniform')")
    if cfg.noise_rdm_impl == "pallas_prng" and cfg.noise_dist != "uniform":
        raise ValueError("noise_rdm_impl='pallas_prng' implements uniform "
                         "rails only; set noise_dist='uniform'")


def make_lowrank_stages(cfg: RadarConfig, precomp, *, device,
                        accelerator_dtypes: bool | None = None
                        ) -> LowrankStages:
    """The rank-K stages on ``device``; the kernel routes take
    ``route_dtypes(cfg, accelerator_dtypes)``, by default the device's
    (JAX's accelerator dtypes on a CUDA device, interpret mode's on the
    CPU)."""
    check_config(cfg)
    if accelerator_dtypes is None:
        accelerator_dtypes = torch.device(device).type == "cuda"
    dts = route_dtypes(cfg, accelerator_dtypes)
    impl = cfg.noise_rdm_impl
    prec = cfg.matmul_precision
    c64 = torch.complex64
    num_p = cfg.sig.prt_num
    w_eff = dbf_weights_effective_np(np.asarray(precomp.dbf_w),
                                     cfg.dbf_variant)
    mix_np = np.ascontiguousarray(w_eff.T)                  # [C, B]
    num_b = mix_np.shape[1]
    l_t = torch.as_tensor(beam_noise_factor(w_eff)).to(device=device,
                                                       dtype=c64)
    if cfg.pc_method == "matmul":
        mplan_np = make_matmul_plan(precomp)
        mplan = to_device(mplan_np, device)
        nplan, nlen = (compact_noise_plan(mplan_np) if cfg.compact_noise
                       else (mplan_np, cfg.sig.point_prt))
        nplan = to_device(nplan, device)
    else:
        mplan = nplan = None
        pplan, nlen = make_plan(precomp), cfg.sig.point_prt
    if cfg.mtd_method == "matmul":
        mtd_np = make_mtd_matrix(precomp.mtd_win, num_p, cfg.mtd_fft_len)
        mtd_t = torch.as_tensor(mtd_np).to(device=device, dtype=c64)

    def _pc(x, plan):
        if plan is None:
            return pulse_compress(x, precomp, pplan)
        return pulse_compress_matmul(x, plan, precision=prec)

    def _mtd(x):
        if cfg.mtd_method != "matmul":
            return mtd(x, precomp.mtd_win, cfg.mtd_fft_len)
        return mtd_matmul(x, mtd_t, precision=prec)

    def signal_factors(targets):
        dop_amp, base, steer_b = synthesize_factors(targets, precomp, cfg,
                                                    mix_np, device=device)
        pc_base = _pc(base[:, :, None], mplan)[:, :, 0]           # [K, G]
        dop_v = _mtd(dop_amp.T[:, None, :])[:, 0, :].T           # [K, V]
        return dop_v, pc_base, steer_b

    def signal_rdm(targets, layout="vgb"):
        dop_v, pc_base, steer_b = signal_factors(targets)
        spec = "kv,kj,kb->bvj" if layout == "bvg" else "kv,kj,kb->vjb"
        return torch.einsum(spec, dop_v, pc_base, steer_b)

    def gen_noise(frame_seed):
        return white_complex_noise((num_p, nlen, num_b),
                                   seeded_generator(frame_seed, device),
                                   device=device)

    def pc(z):
        return _pc(z, nplan)

    def mix_add(rdm_sig, rdm_z):
        return rdm_sig + torch.einsum("vgj,bj->vgb", rdm_z, l_t)

    rplan = noise_rdm_fn = noise_planes = noise_rdm_sig = None
    if impl != "xla":
        rplan = make_rdm_plan(precomp, mtd_np, num_p, tile=128, lane=128,
                              device=device)

    if impl == "pallas":
        def noise_planes(frame_seed):
            # per segment one (re, im) draw of [2, B, P, xlen]; only the
            # pad_front causal history is zeroed (the JAX generator's
            # relabelling of iid draws, radar_tpu/pipeline/lowrank.py:201)
            g = seeded_generator(frame_seed, device)
            out = []
            for seg in rplan.segments:
                shape = (2, num_b, num_p, seg.xlen)
                if cfg.noise_dist == "uniform":
                    x = torch.rand(shape, generator=g, device=device)
                    x = (x * 2.0 - 1.0) * A_UNIF
                else:
                    x = torch.randn(shape, generator=g, device=device)
                    x = x * ROOT2INV
                x[..., :seg.pad_front] = 0.0
                x = x.to(dts.planes)     # JAX's astype(mul), :217-218
                out.append((x[0], x[1]))
            return out

    if impl != "xla":
        def noise_rdm_fn(frame_seed, layout="vgb", planes=None, signal=None,
                         out_dtype=dts.noise_out, emit_maps=False):
            if planes is None and noise_planes is not None:
                planes = noise_planes(frame_seed)
            seed = None if planes is not None else seed_words(frame_seed)
            return noise_rdm(rplan, l_t, signal, seed=seed, planes=planes,
                             layout=layout, mul_dtype=dts.mul,
                             out_dtype=out_dtype, emit_maps=emit_maps)

    if impl == "pallas_prng":
        def noise_rdm_sig(frame_seed, targets, layout="vgb", planes=None,
                          emit_maps=False):
            """The complete RDM from one K1 call (the signal fused), in
            bfloat16 values under ``cfg.kernel_out_bf16``; with
            ``emit_maps`` also its pair maps (``ops/noise_rdm.py::
            maps_buffer``), from the unrounded map."""
            return noise_rdm_fn(frame_seed, layout, planes,
                                signal_factors(targets),
                                out_dtype=dts.sig_out, emit_maps=emit_maps)

    def noisy_rdm(rdm_sig, frame_seed, noise=None, noise_planes=None):
        """The route's complete RDM from a signal RDM in ``rdm_layout``:
        injected white z (``noise``, xla) or per-segment planes
        (``noise_planes``, kernel routes) replace the draws."""
        if impl == "xla":
            if noise_planes is not None:
                raise ValueError("noise_rdm_impl='xla' takes injected white "
                                 "noise as noise=")
            z = gen_noise(frame_seed) if noise is None else \
                torch.as_tensor(noise, device=device).to(c64)
            if z.shape != (num_p, nlen, num_b):
                raise ValueError(f"the xla route takes white noise "
                                 f"{(num_p, nlen, num_b)}, got "
                                 f"{tuple(z.shape)}")
            return mix_add(rdm_sig, _mtd(pc(z)))
        if noise is not None:
            raise ValueError(f"noise_rdm_impl={impl!r} takes injected noise "
                             "as noise_planes=")
        return rdm_sig + noise_rdm_fn(frame_seed, layout="bvg",
                                      planes=noise_planes)

    return LowrankStages(
        impl=impl, rdm_layout="vgb" if impl == "xla" else "bvg",
        signal_factors=signal_factors, signal_rdm=signal_rdm,
        gen_noise=gen_noise, pc=pc, mtd=_mtd, mix_add=mix_add,
        noisy_rdm=noisy_rdm, noise_rdm=noise_rdm_fn,
        noise_planes=noise_planes, noise_rdm_sig=noise_rdm_sig,
        rplan=rplan, l_factor=l_t, dtypes=dts)
