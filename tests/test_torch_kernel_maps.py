"""PyTorch port: kernel K1's two modes of the kernel-maps tail — the pair
maps it writes (``emit_maps``, ``cfg.kernel_maps``) and its bfloat16
output (``cfg.kernel_out_bf16``) — in their plain versions, held against
the JAX package's ``noise_rdm_pallas_gen(emit_maps=True)`` (interpret
mode, small_test_config) and against the port's own map.

JAX's kernel draws its own noise, so the maps are held through the
relation the kernel defines: the port's plain maps of JAX's own map equal
JAX's maps at rtol 1e-6 (sqrt(re^2 + im^2) rounded in another order).
Within the port: the map is the same bit for bit with and without the maps,
the maps are ``pair_maps_plain`` of the unrounded map bit for bit in K2's
padded layout (halo and padding zero), and the bfloat16 map is the f32 map
rounded to bfloat16 values while its maps stay those of the f32 map."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops.dbf import dbf_weights_effective_np as j_weff
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.pallas_rdm import make_rdm_plan as j_rdm_plan
from radar_tpu.ops.pallas_rdm import noise_rdm_pallas_gen
from radar_tpu.sim.echo import beam_noise_factor as j_noise_factor
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops import noise_rdm as nr
from radar_tpu_torch.ops.cfar_kernel import HALO, pad_maps_qvg
from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy

TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
SEED = (3, 5)
OVER = {**jparams.PERF_OVERRIDES, "matmul_precision": "f32"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores; these
    small-shape tests run torch on one thread, so the workers do not
    oversubscribe the cores (no hold here depends on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """JAX's (map, maps) of one in-kernel-draw call with the signal fused,
    and the port's rank-K stages at the same precompute."""
    jcfg = jparams.small_test_config().replace(**OVER)
    jpre = j_precompute(jcfg)
    mtd = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num)
    jplan = j_rdm_plan(jpre, mtd, jcfg.sig.prt_num, tile=128, lane=128)
    l_np = j_noise_factor(j_weff(jpre.dbf_w, jcfg.dbf_variant))
    tcfg = tparams.small_test_config().replace(**OVER)
    tpre = from_numpy(jpre._asdict())
    tl = make_lowrank_stages(tcfg, tpre, device="cpu")
    factors = tl.signal_factors(TargetBatch.make(*TARGETS))
    planes = nr.philox_planes(tl.rplan, SEED, 5, device="cpu")
    rdm, maps = noise_rdm_pallas_gen(
        jnp.asarray(SEED, jnp.int32), jplan, l_np, float(np.sqrt(1.5)),
        interpret=True, mul_dtype=jnp.float32, out_dtype=jnp.float32,
        layout="bvg", rolling=True,
        signal=tuple(jnp.asarray(f.numpy()) for f in factors),
        emit_maps=True)
    return dict(tcfg=tcfg, tpre=tpre, tl=tl, factors=factors,
                planes=planes, rdm=np.array(rdm), maps=np.array(maps),
                y32=nr.noise_rdm_plain(tl.rplan, tl.l_factor, planes,
                                       factors))


def test_plain_maps_match_jax_kernel_maps(setup):
    rdm, want = setup["rdm"], setup["maps"]
    num_b, num_v, num_g = rdm.shape
    got = nr.pair_maps_plain(torch.from_numpy(rdm))
    assert want.shape == (num_b - 1, num_v, num_g)
    assert float(np.abs(want).max()) > 0.0
    assert got.shape == pad_maps_qvg(torch.from_numpy(want)).shape
    np.testing.assert_allclose(
        got[:, :num_v, HALO:HALO + num_g].numpy(), want, rtol=1e-6)
    pad = got.clone()
    pad[:, :num_v, HALO:HALO + num_g] = 0.0
    assert not pad.any()


def test_emit_maps_keeps_the_map_bit_for_bit(setup):
    """Planes mode and draw mode (K1's draws are the Philox planes): the
    map equals K1's map without the maps, the maps ``pair_maps_plain`` of
    it; the "vgb" layout is a view of the same map."""
    tl, y32 = setup["tl"], setup["y32"]
    rdm, maps = nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"],
                             planes=setup["planes"], layout="vgb",
                             emit_maps=True)
    assert torch.equal(rdm, y32.permute(1, 2, 0))
    assert torch.equal(maps, nr.pair_maps_plain(y32))
    drawn, maps_d = nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"],
                                 seed=SEED, layout="bvg", emit_maps=True)
    assert torch.equal(drawn, y32) and torch.equal(maps_d, maps)


def test_bf16_output_rounds_the_map_not_the_maps(setup):
    tl, y32 = setup["tl"], setup["y32"]
    kw = dict(planes=setup["planes"], layout="bvg",
              out_dtype=torch.bfloat16)
    rdm16, maps16 = nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"],
                                 emit_maps=True, **kw)
    assert rdm16.dtype == torch.complex64
    assert torch.equal(rdm16, nr.round_mul(y32, torch.bfloat16))
    assert not torch.equal(rdm16, y32)
    assert torch.equal(maps16, nr.pair_maps_plain(y32))
    assert torch.equal(nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"],
                                    **kw), rdm16)


def test_kernel_out_bf16_rounds_only_the_signal_fused_map(setup):
    """As JAX (radar_tpu/pipeline/lowrank.py:150-173): the frame's
    signal-fused map in bfloat16 values, the noise-only map (the trials')
    in f32."""
    l32, planes = setup["tl"], setup["planes"]
    l16 = make_lowrank_stages(setup["tcfg"].replace(kernel_out_bf16=True),
                              setup["tpre"], device="cpu")
    tb = TargetBatch.make(*TARGETS)
    b, maps = l16.noise_rdm_sig(7, tb, layout="bvg", planes=planes,
                                emit_maps=True)
    assert torch.equal(b, nr.round_mul(setup["y32"], torch.bfloat16))
    assert torch.equal(maps, nr.pair_maps_plain(setup["y32"]))
    assert torch.equal(l16.noise_rdm(7, layout="bvg", planes=planes),
                       l32.noise_rdm(7, layout="bvg", planes=planes))


def test_modes_refuse_what_k1_does_not_run(setup):
    tl = setup["tl"]
    with pytest.raises(ValueError, match="signal"):
        nr.noise_rdm(tl.rplan, tl.l_factor, seed=SEED, emit_maps=True)
    with pytest.raises(ValueError, match="rolling"):
        nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"], seed=SEED,
                     rolling=False, emit_maps=True)
