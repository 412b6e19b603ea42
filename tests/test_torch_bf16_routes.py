"""PyTorch port: the dtypes of the rank-K stream's kernel routes
(``pipeline/lowrank.py::route_dtypes``) against the two branches of the
JAX package's ``make_lowrank_stages`` (its accelerator's and interpret
mode's), the route stages and the kernel-maps frame at the accelerator's
dtypes in their plain versions, and ``validate_rdm_gen``'s checks at JAX's
effective dtypes, on the CPU at small_test_config.

The JAX branches are read by recording the dtypes its stages hand to
``noise_rdm_pallas_gen`` and ``noise_rdm_pallas_planes`` (stand-ins that
return zeros: the accelerator branch cannot run here) and the dtype of the
planes its "pallas" route draws. Within the port the holds are exact: the
same arithmetic gives the same bits."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radar_tpu.ops.pallas_rdm as j_pallas_rdm
from radar_tpu.config import params as jparams
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.pulse_compression import make_matmul_plan as j_matmul_plan
from radar_tpu.pipeline.lowrank import make_lowrank_stages as j_lowrank
from radar_tpu.sim.scenario import TargetBatch as JTargets
from radar_tpu.waveform.precompute import precompute as j_precompute

import radar_tpu_torch.pipeline.lowrank as t_lowrank
from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops import noise_rdm as nr
from radar_tpu_torch.ops.cfar_kernel import HALO
from radar_tpu_torch.pipeline.frame import (detection_tail,
                                            make_frame_processor,
                                            measure_consts)
from radar_tpu_torch.pipeline.lowrank import (make_lowrank_stages,
                                              route_dtypes)
from radar_tpu_torch.scripts import validate_rdm_gen
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy, precompute

TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
PERF = {**jparams.PERF_OVERRIDES, "matmul_precision": "f32"}
BF, F32 = torch.bfloat16, torch.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores; these
    small-shape tests run torch on one thread (no hold depends on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jpre():
    return j_precompute(jparams.small_test_config().replace(**PERF))


def _torch_dtype(d) -> torch.dtype:
    return getattr(torch, jnp.dtype(d).name)


def _jax_branch(monkeypatch, jcfg, jpre, interpret: bool) -> dict:
    """The dtypes JAX's stages pass in one branch: the kernel's mul_dtype,
    the noise-only and the signal-fused map's out_dtype, the drawn planes'
    dtype (the "pallas" route)."""
    seen = []

    def record(*args, **kw):
        seen.append((kw["mul_dtype"], kw["out_dtype"]))
        return jnp.zeros((1,), jnp.complex64)

    monkeypatch.setattr(j_pallas_rdm, "noise_rdm_pallas_gen", record)
    monkeypatch.setattr(j_pallas_rdm, "noise_rdm_pallas_planes", record)
    mtd = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num)
    jl = j_lowrank(jcfg, jpre, None, j_matmul_plan(jpre), mtd, jpre.mtd_win,
                   jnp.complex64)
    key = jax.random.PRNGKey(3)
    jl.noise_rdm(key, interpret=interpret)
    out = {"mul": _torch_dtype(seen[0][0]),
           "noise_out": _torch_dtype(seen[0][1])}
    if jl.noise_rdm_sig is not None:
        jl.noise_rdm_sig(key, JTargets.make(*TARGETS), interpret=interpret)
        assert _torch_dtype(seen[1][0]) == out["mul"]
        out["sig_out"] = _torch_dtype(seen[1][1])
    if jl.noise_planes is not None:
        xrs, _ = jl.noise_planes(key, interpret=interpret)
        out["planes"] = _torch_dtype(xrs[0].dtype)
    return out


def _port_branch(monkeypatch, tcfg, tpre, accelerator: bool) -> dict:
    """The same dtypes as the port's stages (plain versions, on the CPU)
    pass them to ``noise_rdm`` at ``accelerator_dtypes=accelerator``."""
    seen = []

    def record(*args, mul_dtype, out_dtype, **kw):
        seen.append((mul_dtype, out_dtype))
        return torch.zeros((1,), dtype=torch.complex64)

    tl = make_lowrank_stages(tcfg, tpre, device="cpu",
                             accelerator_dtypes=accelerator)
    monkeypatch.setattr(t_lowrank, "noise_rdm", record)
    tl.noise_rdm(3)
    out = {"mul": seen[0][0], "noise_out": seen[0][1]}
    if tl.noise_rdm_sig is not None:
        tl.noise_rdm_sig(3, TargetBatch.make(*TARGETS))
        assert seen[1][0] == out["mul"]
        out["sig_out"] = seen[1][1]
    if tl.noise_planes is not None:
        out["planes"] = tl.noise_planes(3)[0][0].dtype
    return out


@pytest.mark.parametrize("impl,kout", [("pallas_prng", False),
                                       ("pallas_prng", True),
                                       ("pallas", False)])
def test_route_dtypes_match_jax_branches(monkeypatch, jpre, impl, kout):
    """The accelerator's dtypes (a CUDA device) are JAX's non-interpret
    branch, interpret mode's (the CPU) its interpret branch; the port's
    stages pass them to the kernel."""
    over = dict(noise_rdm_impl=impl, kernel_out_bf16=kout)
    jcfg = jparams.small_test_config().replace(**{**PERF, **over})
    tcfg = tparams.small_test_config().replace(**{**PERF, **over})
    tpre = from_numpy(jpre._asdict())
    for accelerator in (True, False):
        want = _jax_branch(monkeypatch, jcfg, jpre,
                           interpret=not accelerator)
        dts = route_dtypes(tcfg, accelerator)._asdict()
        assert {k: dts[k] for k in want} == want
        assert _port_branch(monkeypatch, tcfg, tpre, accelerator) == want
        monkeypatch.undo()
    assert route_dtypes(tcfg, True).mul == BF


def test_pallas_route_planes_and_map_at_accelerator_dtypes(jpre):
    """The "pallas" route at the accelerator's dtypes: its drawn planes
    are the interpret-mode draws rounded to bf16 bit for bit, and its
    noise-only map is the plain K1 at bf16 operands and bf16 output on
    them."""
    tcfg = tparams.small_test_config().replace(
        **{**PERF, "noise_rdm_impl": "pallas"})
    tpre = from_numpy(jpre._asdict())
    acc = make_lowrank_stages(tcfg, tpre, device="cpu",
                              accelerator_dtypes=True)
    cpu = make_lowrank_stages(tcfg, tpre, device="cpu")
    assert cpu.dtypes == route_dtypes(tcfg, False)
    planes16, planes32 = acc.noise_planes(7), cpu.noise_planes(7)
    for (a, b), (c, d) in zip(planes16, planes32):
        assert a.dtype == b.dtype == BF and c.dtype == F32
        assert torch.equal(a, c.to(BF)) and torch.equal(b, d.to(BF))
    got = acc.noise_rdm(7, layout="bvg")
    want = nr.noise_rdm_plain(acc.rplan, acc.l_factor, planes16,
                              mul_dtype=BF, out_dtype=BF)
    assert torch.equal(got, want)
    assert not torch.equal(got, cpu.noise_rdm(7, layout="bvg"))


@pytest.mark.parametrize("kout", [False, True])
def test_kernel_maps_frame_at_accelerator_dtypes(kout):
    """The kernel-maps frame at the accelerator's dtypes (plain versions):
    K1 at bf16 operands gives the map (f32, or bf16 values under
    kernel_out_bf16) and the pair maps of its unrounded map; the frame's
    detections are the plain qvg tail's on that map and those maps, and
    both truth targets are found as at interpret mode's dtypes."""
    cfg = tparams.small_test_config().replace(
        **PERF, kernel_maps=True, kernel_out_bf16=kout)
    proc = make_frame_processor(cfg, device="cpu", accelerator_dtypes=True)
    lr, tb = proc.stages, TargetBatch.make(*TARGETS)
    assert lr.dtypes.mul == BF
    rdm, maps = lr.noise_rdm_sig(5, tb, layout="bvg", emit_maps=True)
    y = nr.noise_rdm(lr.rplan, lr.l_factor, lr.signal_factors(tb),
                     seed=nr.seed_words(5), layout="bvg", mul_dtype=BF)
    assert torch.equal(rdm, nr.round_mul(y, lr.dtypes.sig_out))
    assert torch.equal(maps, nr.pair_maps_plain(y))
    assert float(maps[:, :y.shape[1], HALO:HALO + y.shape[2]].min()) > 0.0
    res = proc(5, tb)
    tail = detection_tail(cfg, measure_consts(cfg, precompute(cfg),
                                              device="cpu"), rdm,
                          "bvg", "qvg", maps_p=maps)[-1]
    for f in ("range_m", "velocity_ms", "angle_deg", "power", "valid"):
        assert torch.equal(getattr(res.targets, f), getattr(tail.targets, f))
    f32 = make_frame_processor(cfg, device="cpu")(5, tb)
    assert int(res.num_final) == int(f32.num_final) >= 2


def test_validate_rdm_gen_checks_at_jax_dtypes(monkeypatch):
    """``validate_rdm_gen``'s bit and rolling checks run the kernels at
    bf16 operands and f32 output, as JAX's script does (its kernels'
    default mul_dtype): K1c's planes are bf16, every check call multiplies
    in bf16, both checks hold at 0, and the map they check is 1e-3..1e-2
    RMS away from the f32 kernels' map on the same draws."""
    calls = []
    real = nr.noise_rdm

    def spy(*args, **kw):
        calls.append((kw.get("mul_dtype", F32), kw.get("out_dtype", F32)))
        return real(*args, **kw)

    monkeypatch.setattr(validate_rdm_gen, "FRAMES", 1)
    monkeypatch.setattr(nr, "noise_rdm", spy)
    cfg = tparams.perf_config(tparams.small_test_config())
    out, planes, seed = validate_rdm_gen.validate(cfg, torch.device("cpu"))
    monkeypatch.undo()
    assert calls == [(BF, F32)] * 3
    assert all(x.dtype == BF for pair in planes for x in pair)
    assert out["dtypes"]["checks_mul"] == "bfloat16"
    assert out["dtypes"]["moments_pallas_prng"]["mul"] == "float32"
    assert out["bit_check"]["max_abs_diff"] == 0.0 and out["bit_check"]["pass"]
    assert out["rolling_check"]["max_abs_diff"] == 0.0
    st = make_lowrank_stages(cfg, precompute(cfg), device="cpu")
    y16 = nr.noise_rdm(st.rplan, st.l_factor, seed=seed, layout="bvg",
                       mul_dtype=BF)
    y32 = nr.noise_rdm(st.rplan, st.l_factor, seed=seed, layout="bvg")
    assert float(y16.abs().max()) == out["bit_check"]["max_abs_out"]
    rms = float(y32.abs().pow(2).mean().sqrt())
    assert 1e-3 * rms <= float((y16 - y32).abs().pow(2).mean().sqrt()) \
        <= 1e-2 * rms
