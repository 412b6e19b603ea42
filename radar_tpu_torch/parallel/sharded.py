"""One frame sharded over a mesh, with explicit collectives — port of
``radar_tpu/parallel/sharded.py``.

Where JAX annotates stage boundaries and lets GSPMD insert the collectives,
every rank here runs its block of the frame and calls them itself:

  stage           this rank holds                   collective into it
  ---------------------------------------------------------------------
  raw IQ [P,S,C]  P block over the frame axes,     (synthesized in place)
                  C block over ``ch``
  DBF    [P,S,B]  P block, all beams                all-reduce over ch
  PC     [P,G,B]  P block                           none (pulse-parallel)
  MTD    [V,G,B]  G block over the frame axes       all-to-all pulses->gates
  RDM    [V,G,B]  all of it                         all-gather over the
                                                    frame axes

and then the port's single-device tail for the configuration (K3 on the
vgq tail, K2 with ``use_pallas_cfar``) on every rank. The fused stream
(``fused_synth_dbf`` without ``lowrank_rdm``) runs this reference stream
too, as JAX's does (``radar_tpu/parallel/sharded.py:106-119``): its echoes
are synthesized per element, so that the channel axis has a cube to
shard, the AWGN is channel noise (K5 under ``noise_impl="pallas"``) and
DBF's all-reduce forms the beams. The rank-K stream (``lowrank_rdm``
with ``fused_synth_dbf``) has no channel cube: white beam
noise and its PC are pulse-sharded, the all-to-all feeds the MTD, and the
beam mix plus the rank-K signal run on the gate block (JAX's
``sharded.py:95-105``); like JAX's mesh path it runs the xla chain, so the
kernel routes (``noise_rdm_impl="pallas"/"pallas_prng"``) shard the batch
instead (``parallel/dp.py``).

Draws. Every rank draws the frame's whole noise cube from the frame seed,
as the single-device stream does, and keeps its own block; so a sharded
frame and the single-device frame of the same seed see the same noise, and
differ only by the order of the DBF's partial sums and the shapes of the
products.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.params import RadarConfig
from ..ops.awgn import awgn
from ..ops.dbf import dbf_weights_effective_np
from ..ops.noise_rdm import seed_words
from ..pipeline.frame import FrameResult, make_frame_stages
from ..sim.echo import _target_factors, seeded_generator, white_complex_noise
from ..waveform.precompute import Precomputed, precompute
from .collectives import pulses_to_gates
from .mesh import AXIS_CH, AXIS_CPI, AXIS_DP, Mesh, _axes


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{n} {what} not divisible by {parts} shards")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def make_sharded_frame_processor(cfg: RadarConfig, mesh: Mesh,
                                 precomp: Precomputed | None = None, *,
                                 frame_axes=(AXIS_DP, AXIS_CPI)):
    """``process(frame_seed, targets, noise=None) -> FrameResult``, called
    by every rank of ``mesh`` with the same arguments; each returns the
    whole frame's result, equal to the single-device frame processor's on
    the same seed (up to the order of sums); on the fused stream, the
    single-device frame of the reference stream (``fused_synth_dbf=False``).

    ``frame_axes``: the mesh axes the frame's pulses and gates shard over
    (dp and cpi by default). ``parallel/dp.py::
    make_dp_sharded_frame_processor`` passes ``(cpi,)`` to keep dp free for
    the batch. ``noise``: the stream's whole injected cube, as on the
    single-device streams (channel AWGN [P, S, C] on the reference and
    fused streams, or white z [P, S(_compact), B] on the rank-K stream)."""
    frame_axes = _axes(frame_axes)
    if AXIS_CH in frame_axes:
        raise ValueError("the channel axis cannot shard pulses")
    device = mesh.device
    if precomp is None:
        precomp = precompute(cfg)
    st = make_frame_stages(cfg, precomp, device=device)
    lr = st.lowrank
    if lr is not None and lr.impl != "xla":
        raise NotImplementedError(
            f"cfg.noise_rdm_impl={lr.impl!r}: the sharded rank-K stream "
            "runs the xla chain; the kernel routes shard the batch "
            "(parallel/dp.py)")
    c64 = torch.complex64
    num_p, num_g = cfg.sig.prt_num, precomp.n_total_gate
    n_frame = mesh.size(frame_axes)
    p_sl = _block(num_p, n_frame, mesh.index(frame_axes), "pulses")
    gate0 = mesh.index(frame_axes) * -(-num_g // n_frame)

    def gathered(rdm_block):
        """[V, G/n(+pad), B] gate blocks -> the whole [V, G, B] RDM."""
        return mesh.all_gather(rdm_block, frame_axes, dim=1)[:, :num_g]

    def global_noise(noise, shape):
        """The injected whole cube; ``None`` in ``shape`` takes any
        width."""
        z = torch.as_tensor(noise, device=device).to(c64)
        if z.ndim != len(shape) or any(
                w is not None and w != n for w, n in zip(shape, z.shape)):
            raise ValueError(f"injected noise must be the whole cube "
                             f"{tuple(shape)}, got {tuple(z.shape)}")
        return z

    if lr is not None:
        def process(frame_seed: int, targets, noise=None) -> FrameResult:
            z = lr.gen_noise(frame_seed) if noise is None else \
                global_noise(noise, (num_p, None, lr.l_factor.shape[0]))
            pcz = pulses_to_gates(lr.pc(z[p_sl]), mesh, frame_axes)
            rdm_z = lr.mtd(pcz)                            # [V, G/n, B]
            sig = lr.signal_rdm(targets, "vgb")
            sig = sig[:, gate0:gate0 + rdm_z.shape[1]]
            if sig.shape[1] < rdm_z.shape[1]:              # the padded end
                sig = torch.cat([sig, sig.new_zeros(
                    (sig.shape[0], rdm_z.shape[1] - sig.shape[1],
                     sig.shape[2]))], dim=1)
            rdm = gathered(lr.mix_add(sig, rdm_z))
            return st.detect(rdm, "vgb")[-1]

        return process

    sig_cfg = cfg.sig
    cube = (num_p, sig_cfg.point_prt, sig_cfg.channel_num)
    c_sl = _block(sig_cfg.channel_num, mesh.size(AXIS_CH),
                  mesh.index(AXIS_CH), "channels")
    m_eff = torch.as_tensor(np.ascontiguousarray(dbf_weights_effective_np(
        precomp.dbf_w, cfg.dbf_variant)[:, c_sl])).to(device, c64)

    def process(frame_seed: int, targets, noise=None) -> FrameResult:
        dop_amp, base, steer = _target_factors(targets, precomp, cfg, None,
                                               device=device)
        raw = torch.einsum("kp,ks,kc->psc", dop_amp[:, p_sl], base,
                           steer[:, c_sl])
        if noise is not None:
            z = global_noise(noise, cube)
        elif cfg.noise_impl == "pallas":
            z = awgn(torch.zeros(cube, dtype=c64, device=device),
                     seed_words(frame_seed))
        else:
            z = white_complex_noise(cube, seeded_generator(frame_seed,
                                                           device),
                                    device=device)
        noisy = raw + z[p_sl, :, c_sl]
        beams = mesh.all_reduce(torch.einsum("psc,bc->psb", noisy, m_eff),
                                AXIS_CH)
        pc = pulses_to_gates(st.pc(beams), mesh, frame_axes)
        rdm = gathered(st.mtd(pc))
        return st.detect(rdm, "vgb")[-1]

    return process
