"""PyTorch port: rank-K signal factors, banded-matmul pulse compression,
MTD matrix product, bf16-operand contraction and the lowrank stages, held
against the JAX package on identical inputs.

Tolerances: f32 paths rtol 1e-5 (atol 1e-5 of the reference's largest
magnitude, for values near zero); bf16-operand paths rtol 1e-2. JAX calls
run under jit: the CPU backend's eager dot does not take bf16 x bf16 ->
f32."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops.dbf import dbf_weights_effective_np as j_weff
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.mtd import mtd_matmul as j_mtd_matmul
from radar_tpu.ops.precision import einsum_complex_bf16 as j_einsum_bf16
from radar_tpu.ops.pulse_compression import (
    make_matmul_plan as j_matmul_plan,
    pulse_compress_matmul as j_pc_matmul)
from radar_tpu.pipeline.lowrank import make_lowrank_stages as j_lowrank
from radar_tpu.sim.echo import beam_noise_factor as j_noise_factor
from radar_tpu.sim.echo import synthesize_factors as j_factors
from radar_tpu.sim.scenario import TargetBatch as JTargets
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops.dbf import dbf_weights_effective_np
from radar_tpu_torch.ops.mtd import mtd_matmul
from radar_tpu_torch.ops.precision import einsum_complex_bf16
from radar_tpu_torch.ops.pulse_compression import (make_matmul_plan,
                                                   pulse_compress_matmul)
from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
from radar_tpu_torch.sim.echo import beam_noise_factor, synthesize_factors
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"f32": 1e-5, "bf16": 1e-2}
TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])


def _close(got, want, rtol):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


def _cfgs(precision="f32"):
    over = {**jparams.PERF_OVERRIDES, "matmul_precision": precision,
            "use_pallas_cfar": True}
    return (tparams.small_test_config().replace(**over),
            jparams.small_test_config().replace(**over))


@pytest.fixture(scope="module")
def setup():
    tcfg, jcfg = _cfgs()
    jpre = j_precompute(jcfg)
    return tcfg, jcfg, jpre, from_numpy(jpre._asdict())


def _rand_c64(rng, shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


def test_synthesize_factors_match_jax(setup):
    tcfg, jcfg, jpre, tpre = setup
    mix = np.ascontiguousarray(j_weff(jpre.dbf_w, jcfg.dbf_variant).T)
    want = j_factors(JTargets.make(*TARGETS), jpre, jcfg, mix,
                     dtype=jnp.complex64)
    got = synthesize_factors(TargetBatch.make(*TARGETS), tpre, tcfg, mix,
                             device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        _close(g, w, TOL["f32"])


def test_beam_noise_factor_matches_jax(setup):
    _, jcfg, jpre, _ = setup
    w_eff = dbf_weights_effective_np(jpre.dbf_w, jcfg.dbf_variant)
    np.testing.assert_array_equal(w_eff, j_weff(jpre.dbf_w, jcfg.dbf_variant))
    np.testing.assert_allclose(beam_noise_factor(w_eff),
                               j_noise_factor(w_eff), rtol=1e-12, atol=0)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_pulse_compress_matmul_matches_jax(setup, precision):
    _, _, jpre, tpre = setup
    x = _rand_c64(np.random.default_rng(1), (4, jpre.tx_pulse.shape[0], 3))
    jplan = j_matmul_plan(jpre)
    want = jax.jit(lambda y: j_pc_matmul(y, jplan, precision=precision))(
        jnp.asarray(x))
    got = pulse_compress_matmul(torch.from_numpy(x), make_matmul_plan(tpre),
                                precision=precision)
    assert got.shape == want.shape
    _close(got, want, TOL[precision])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_mtd_matmul_matches_jax(setup, precision):
    tcfg, _, jpre, _ = setup
    p = tcfg.sig.prt_num
    m = j_mtd_matrix(jpre.mtd_win, p)
    x = _rand_c64(np.random.default_rng(2), (p, 50, 3))
    want = jax.jit(lambda y: j_mtd_matmul(y, m, precision=precision))(
        jnp.asarray(x))
    got = mtd_matmul(torch.from_numpy(x), m, precision=precision)
    _close(got, want, TOL[precision])


@pytest.mark.parametrize("kinds", ["cc", "cr", "rc", "rr"])
def test_einsum_complex_bf16_matches_jax(kinds):
    rng = np.random.default_rng(3)
    mk = lambda k, shape: (_rand_c64(rng, shape) if k == "c" else
                           rng.standard_normal(shape).astype(np.float32))
    a, b = mk(kinds[0], (6, 40)), mk(kinds[1], (40, 7))
    want = jax.jit(lambda x, y: j_einsum_bf16("ij,jk->ik", x, y))(
        jnp.asarray(a), jnp.asarray(b))
    got = einsum_complex_bf16("ij,jk->ik", torch.from_numpy(a),
                              torch.from_numpy(b))
    # identical bf16 operands, f32 accumulation in another order
    _close(got, want, 1e-5)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_lowrank_stages_match_jax(precision):
    """signal_rdm, the compact-plan pc, mtd and mix_add twins of the JAX
    XLA chain, on the same targets and white noise."""
    tcfg, jcfg = _cfgs(precision)
    jpre = j_precompute(jcfg)
    tpre = from_numpy(jpre._asdict())
    mtd_mat = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num)
    jl = j_lowrank(jcfg, jpre, None, j_matmul_plan(jpre), mtd_mat,
                   jpre.mtd_win, jnp.complex64)
    tl = make_lowrank_stages(tcfg, tpre, device="cpu")
    tol = TOL[precision]

    j_sig = jax.jit(jl.signal_rdm)
    _close(tl.signal_rdm(TargetBatch.make(*TARGETS)),
           j_sig(JTargets.make(*TARGETS)), tol)
    z = _rand_c64(np.random.default_rng(4),
                  (tcfg.sig.prt_num, tl.rplan.s_compact, 5))
    pc_j = jax.jit(jl.pc)(jnp.asarray(z))
    pc_t = tl.pc(torch.from_numpy(z))
    _close(pc_t, pc_j, tol)
    mt_j = jax.jit(jl.mtd)(pc_j)
    mt_t = tl.mtd(torch.from_numpy(np.array(pc_j)))
    _close(mt_t, mt_j, tol)
    sig = np.array(j_sig(JTargets.make(*TARGETS)))
    _close(tl.mix_add(torch.from_numpy(sig), torch.from_numpy(
        np.array(mt_j))), jl.mix_add(jnp.asarray(sig), mt_j), 1e-5)
