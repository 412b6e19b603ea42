"""PyTorch port: the rank-K stream's three noise-RDM routes
(``pipeline/lowrank.py``: ``noise_rdm_impl`` "xla", "pallas",
"pallas_prng") held against the JAX package's ``make_lowrank_stages`` and
frame processor, at small widths on the CPU.

Tolerances: stage outputs (PC, MTD, the mixed RDM, the noise RDM of the
planes kernel) within 1e-5 of the reference's RMS (RMS of the difference;
single cells within 1e-4 of the RMS: f32 sums of up to 700 x 32 terms
taken in another order); frames: equal final counts, range, velocity,
angle and power rtol 1e-4. The route's own draws are held by their
moments: rail mean within 5 sigma of 0, variance within 2% of 1/2."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops.dbf import dbf_weights_effective_np as j_weff
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.pallas_rdm import (make_rdm_plan as j_rdm_plan,
                                      noise_rdm_pallas,
                                      noise_rdm_pallas_planes,
                                      segment_buffer_len)
from radar_tpu.ops.pulse_compression import make_matmul_plan as j_matmul_plan
from radar_tpu.ops.pulse_compression import make_plan as j_make_plan
from radar_tpu.pipeline.frame import make_frame_processor as j_make
from radar_tpu.pipeline.lowrank import make_lowrank_stages as j_lowrank
from radar_tpu.sim.echo import beam_noise_factor as j_noise_factor
from radar_tpu.sim.scenario import TargetBatch as JTargets
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops import noise_rdm as nr
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.pipeline.lowrank import A_UNIF, make_lowrank_stages
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
FIELDS = ("range_m", "velocity_ms", "angle_deg", "power")
PERF = {**jparams.PERF_OVERRIDES, "matmul_precision": "f32",
        "use_pallas_cfar": True}
VARIANTS = {"compact": {}, "full": {"compact_noise": False},
            "fft": {"pc_method": "fft", "mtd_method": "fft"}}


def _close(got, want, rtol=1e-5):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))
    err = got.astype(np.complex128) - want
    assert rms(err) <= rtol * rms(want)
    assert float(np.max(np.abs(err))) <= 10 * rtol * rms(want)


def _cfgs(**over):
    return (jparams.small_test_config().replace(**{**PERF, **over}),
            tparams.small_test_config().replace(**{**PERF, **over}))


@functools.lru_cache(maxsize=1)
def _tpre():
    """The port's precompute of the small config (JAX's, as numpy)."""
    return from_numpy(j_precompute(jparams.small_test_config())._asdict())


def _jax_stages(jcfg, jpre):
    matmul = jcfg.pc_method == "matmul"
    mtd = (j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num)
           if jcfg.mtd_method == "matmul" else None)
    return j_lowrank(jcfg, jpre, j_make_plan(jpre),
                     j_matmul_plan(jpre) if matmul else None, mtd,
                     jpre.mtd_win, jnp.complex64)


def _white(rng, shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


@pytest.fixture(scope="module", params=list(VARIANTS))
def xla_pair(request):
    """The xla route's stages in both packages on the same white z."""
    jcfg, tcfg = _cfgs(noise_rdm_impl="xla", **VARIANTS[request.param])
    jpre = j_precompute(jcfg)
    jl = _jax_stages(jcfg, jpre)
    tl = make_lowrank_stages(tcfg, from_numpy(jpre._asdict()), device="cpu")
    z = _white(np.random.default_rng(5), tuple(tl.gen_noise(0).shape))
    jpc = jl.pc(jnp.asarray(z))
    jmtd = jl.mtd(jpc)
    want = {"pc": jpc, "mtd": jmtd,
            "mix_add": jl.mix_add(jl.signal_rdm(JTargets.make(*TARGETS)),
                                  jmtd)}
    tpc = tl.pc(torch.from_numpy(z))
    tmtd = tl.mtd(tpc)
    got = {"pc": tpc, "mtd": tmtd,
           "mix_add": tl.noisy_rdm(tl.signal_rdm(TargetBatch.make(*TARGETS)),
                                   0, noise=z)}
    return dict(jl=jl, tl=tl, want=want, got=got, name=request.param)


@pytest.mark.parametrize("stage", ["pc", "mtd", "mix_add"])
def test_xla_chain_matches_jax(xla_pair, stage):
    _close(xla_pair["got"][stage], xla_pair["want"][stage])


def test_gen_noise_shape_and_moments(xla_pair):
    """White z [P, S, B]: compact (the samples PC reads) or the whole PRT,
    as JAX's gen_noise draws it; CN(0,1) rails."""
    z = xla_pair["tl"].gen_noise(7)
    want = xla_pair["jl"].gen_noise(jax.random.PRNGKey(0))
    assert tuple(z.shape) == tuple(want.shape)
    assert z.dtype == torch.complex64
    full = xla_pair["name"] != "compact"
    assert (z.shape[1] == 5819) == full
    rails = torch.cat([z.real.reshape(-1), z.imag.reshape(-1)]).double()
    assert abs(float(rails.mean())) < 5 * np.sqrt(0.5 / rails.numel())
    assert abs(float(rails.var()) / 0.5 - 1.0) < 0.02
    assert torch.equal(z, xla_pair["tl"].gen_noise(7))
    assert not torch.equal(z, xla_pair["tl"].gen_noise(8))


@pytest.mark.parametrize("dist", ["normal", "uniform"])
def test_pallas_route_draws_planes_per_segment(dist):
    _, tcfg = _cfgs(noise_rdm_impl="pallas", noise_dist=dist)
    tl = make_lowrank_stages(tcfg, _tpre(), device="cpu")
    planes = tl.noise_planes(3)
    rails = []
    for seg, (xr, xi) in zip(tl.rplan.segments, planes):
        assert xr.shape == xi.shape == (5, 32, seg.xlen)
        assert xr.dtype == torch.float32
        assert torch.all(xr[..., :seg.pad_front] == 0)
        assert torch.all(xi[..., :seg.pad_front] == 0)
        rails += [xr[..., seg.pad_front:].reshape(-1),
                  xi[..., seg.pad_front:].reshape(-1)]
    u = torch.cat(rails).double()
    assert abs(float(u.mean())) < 5 * np.sqrt(0.5 / u.numel())
    assert abs(float(u.var()) / 0.5 - 1.0) < 0.02
    if dist == "uniform":
        assert float(u.min()) >= -A_UNIF and float(u.max()) < A_UNIF
    else:
        assert float(u.abs().max()) > A_UNIF
    again = tl.noise_planes(3)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(planes, again))


def _jax_plan(jcfg, jpre):
    mtd = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num)
    l_np = j_noise_factor(j_weff(jpre.dbf_w, jcfg.dbf_variant))
    return j_rdm_plan(jpre, mtd, jcfg.sig.prt_num, tile=128, lane=128), l_np


def test_pallas_route_noise_rdm_matches_jax_planes_kernel():
    """The route's noise-only RDM (K1 planes mode, plain version) vs the
    JAX planes kernel (interpret, f32 multiply) on the same planes."""
    jcfg, tcfg = _cfgs(noise_rdm_impl="pallas", noise_dist="normal")
    jpre = j_precompute(jcfg)
    jplan, l_np = _jax_plan(jcfg, jpre)
    tl = make_lowrank_stages(tcfg, from_numpy(jpre._asdict()), device="cpu")
    planes = tl.noise_planes(11)
    xrs, xis = [], []
    for seg, (xr, xi) in zip(jplan.segments, planes):
        pad = ((0, 0), (0, jplan.p_pad - xr.shape[1]),
               (0, segment_buffer_len(seg) - xr.shape[2]))
        xrs.append(jnp.asarray(np.pad(xr.numpy(), pad)))
        xis.append(jnp.asarray(np.pad(xi.numpy(), pad)))
    want = noise_rdm_pallas_planes(xrs, xis, jplan, l_np, interpret=True,
                                   mul_dtype=jnp.float32)
    _close(tl.noise_rdm(0, layout="vgb", planes=planes), want)
    assert torch.equal(tl.noise_rdm(11, layout="vgb"),
                       tl.noise_rdm(0, layout="vgb", planes=planes))


def test_noise_rdm_compact_matches_jax():
    """``noise_rdm_compact`` (compact z -> planes -> K1 planes mode) vs JAX
    ``noise_rdm_pallas`` (interpret, f32 multiply)."""
    jcfg, tcfg = _cfgs()
    jpre = j_precompute(jcfg)
    jplan, l_np = _jax_plan(jcfg, jpre)
    tl = make_lowrank_stages(tcfg, from_numpy(jpre._asdict()), device="cpu")
    z = _white(np.random.default_rng(9), (5, 32, tl.rplan.s_compact))
    want = noise_rdm_pallas(jnp.asarray(z), jplan, l_np, interpret=True,
                            mul_dtype=jnp.float32)
    got = nr.noise_rdm_compact(torch.from_numpy(z), tl.rplan, tl.l_factor)
    assert float(np.max(np.abs(np.asarray(want)))) > 0.0
    _close(got, want)


def _rows(t):
    host = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    valid = host(t.valid)
    return np.stack([host(getattr(t, f))[valid] for f in FIELDS],
                    1).astype(np.float64)


def _assert_same_targets(got, want, **kw):
    """Rows of ``got`` paired with the nearest row of ``want`` in (range,
    velocity) (split targets can share a range to 1e-4), then compared."""
    a, b = _rows(got), _rows(want)
    assert a.shape == b.shape
    dist = (np.abs(a[:, None, 0] - b[None, :, 0])
            + 10 * np.abs(a[:, None, 1] - b[None, :, 1]))
    pair = np.argmin(dist, axis=1)
    assert len(set(pair.tolist())) == len(pair)
    np.testing.assert_allclose(a, b[pair], **kw)


@pytest.mark.parametrize("impl,dist", [("xla", "normal"),
                                       ("pallas", "normal"),
                                       ("pallas", "uniform")])
def test_route_frame_matches_jax(impl, dist):
    """The perf frame on each route vs JAX's frame on its own draws,
    injected into the port (white z for xla, the planes for pallas)."""
    jcfg, tcfg = _cfgs(noise_rdm_impl=impl, noise_dist=dist)
    jpre = j_precompute(jcfg)
    jl = _jax_stages(jcfg, jpre)
    key = jax.random.PRNGKey(6)
    want = j_make(jcfg, jpre)(key, JTargets.make(*TARGETS))
    process = make_frame_processor(tcfg, from_numpy(jpre._asdict()),
                                   device="cpu")
    tb = TargetBatch.make(*TARGETS)
    if impl == "xla":
        got = process(0, tb, noise=np.array(jl.gen_noise(key)))
    else:
        xrs, xis = jl.noise_planes(key, interpret=True)
        got = process(0, tb, noise_planes=[
            (torch.from_numpy(np.array(xr)[:, :32]),
             torch.from_numpy(np.array(xi)[:, :32]))
            for xr, xi in zip(xrs, xis)])
    assert int(got.num_final) == int(want.num_final) >= 2
    _assert_same_targets(got.targets, want.targets, rtol=1e-4)


@pytest.mark.parametrize("impl,dist", [("xla", "normal"),
                                       ("pallas", "uniform"),
                                       ("pallas_prng", "uniform")])
def test_route_frame_detects_truth(impl, dist):
    _, tcfg = _cfgs(noise_rdm_impl=impl, noise_dist=dist)
    process = make_frame_processor(tcfg, _tpre(), device="cpu")
    before = nr.launch_count
    res = process(7, TargetBatch.make([3000.0], [15.0], [10.0], [20.0]))
    assert nr.launch_count == before          # the CPU runs the plain twin
    r = res.targets.range_m[res.targets.valid].numpy()
    assert int(res.num_final) >= 1
    assert np.min(np.abs(r - 3000.0)) < 2 * tcfg.sig.c / tcfg.sig.fs / 2


def test_routes_refuse_what_they_do_not_run():
    _, tcfg = _cfgs()
    for over, err, match in (
            ({"noise_rdm_impl": "pallas", "pc_method": "fft"},
             NotImplementedError, "pc_method"),
            ({"noise_rdm_impl": "pallas_prng", "noise_dist": "normal"},
             ValueError, "uniform"),
            ({"noise_rdm_impl": "triton"}, ValueError, "noise_rdm_impl"),
            ({"noise_rdm_impl": "pallas", "noise_dist": "laplace"},
             ValueError, "noise_dist")):
        with pytest.raises(err, match=match):
            make_lowrank_stages(tcfg.replace(**over), _tpre(), device="cpu")
    tb = TargetBatch.make(*TARGETS)
    xla = make_frame_processor(tcfg.replace(noise_rdm_impl="xla"), _tpre(),
                               device="cpu")
    with pytest.raises(ValueError, match="noise="):
        xla(0, tb, noise_planes=[])
    with pytest.raises(ValueError, match="white noise"):
        xla(0, tb, noise=torch.zeros((32, 10, 5), dtype=torch.complex64))
    pallas = make_frame_processor(tcfg.replace(noise_rdm_impl="pallas"),
                                  _tpre(), device="cpu")
    with pytest.raises(ValueError, match="noise_planes"):
        pallas(0, tb, noise=torch.zeros((32, 10, 5), dtype=torch.complex64))
