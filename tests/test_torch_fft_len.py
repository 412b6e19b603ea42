"""PyTorch port: the rank-K stream's kernel routes at a zero-padded
Doppler FFT (``cfg.mtd_fft_len``: V Doppler bins from P pulses, V != P, as
the reference's main_simulate_echoes_with_array_v7_7.m runs it at 512
points) held against the JAX package at small_test_config (5 beams, 32
pulses, 3404 gates) on the CPU.

Two FFT lengths: 64 (V = 2P, the ratio 512/332 rounds up to) and 40 (V not
a multiple of 8 or 16, so the Doppler rows are padded). For each:

- the "pallas" route's frame, normal and uniform rails, on JAX's planes:
  equal final counts, targets at rtol 1e-4 (``test_torch_lowrank.py``'s
  holds);
- the noise-only RDM of K1's planes mode (plain) against JAX's planes
  kernel in interpret mode at f32 multiplies: RMS of the difference within
  1e-5 of the RMS, single cells within 1e-4 of it;
- K1 at bf16 operands (plain) with the rank-K signal against JAX's rolling
  kernel in interpret mode at ``mul_dtype=bfloat16`` on the planes that
  kernel draws, with and without the pair maps, f32 and bf16 output: RMS
  within 1e-4 (2e-4 at bf16 output), ``test_torch_k1_bf16.py``'s holds.
  JAX's kernel casts its f32 tiles to ``out_dtype`` last
  (``radar_tpu/ops/pallas_rdm.py`` :467-468), so its bf16 output is its f32
  map cast, and one interpret-mode call serves both;
- the perf trials (the rank-K xla route) against JAX's trial function on
  its draws: hits equal, angles rtol 1e-4 (``test_torch_montecarlo.py``'s);
- the "pallas_prng" route finds the truth, with no kernel launch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops.dbf import dbf_weights_effective_np as j_weff
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.pallas_rdm import (gen_noise_planes_pallas,
                                      make_rdm_plan as j_rdm_plan,
                                      noise_rdm_pallas_gen,
                                      noise_rdm_pallas_planes,
                                      segment_buffer_len)
from radar_tpu.ops.pulse_compression import make_matmul_plan as j_matmul_plan
from radar_tpu.ops.pulse_compression import make_plan as j_make_plan
from radar_tpu.pipeline.frame import make_frame_processor as j_make
from radar_tpu.pipeline.lowrank import make_lowrank_stages as j_lowrank
from radar_tpu.pipeline.montecarlo import make_trial_fn as j_trial_fn
from radar_tpu.sim.echo import beam_noise_factor as j_noise_factor
from radar_tpu.sim.scenario import TargetBatch as JTargets
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops import cfar_kernel as ck
from radar_tpu_torch.ops import noise_rdm as nr
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
from radar_tpu_torch.pipeline.montecarlo import make_trial_fn
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FFT_LENS = (64, 40)
TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
FIELDS = ("range_m", "velocity_ms", "angle_deg", "power")
PERF = {**jparams.PERF_OVERRIDES, "matmul_precision": "f32",
        "use_pallas_cfar": True}
A = float(np.sqrt(1.5))
BF = torch.bfloat16
TRIALS = 4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the host's cores; these
    small-shape tests run torch on one thread (no hold depends on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(fft_len, **over):
    over = {**PERF, "mtd_fft_len": fft_len, **over}
    return (jparams.small_test_config().replace(**over),
            tparams.small_test_config().replace(**over))


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.abs(np.asarray(x, np.complex128)) ** 2)))


def _held(got, want, hold: float, cell: float | None = None) -> None:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and _rms(want) > 0.0
    err = got.astype(np.complex128) - want
    assert _rms(err) <= hold * _rms(want)
    if cell is not None:
        assert float(np.max(np.abs(err))) <= cell * _rms(want)


@pytest.fixture(scope="module", params=FFT_LENS)
def setup(request):
    """Both packages' constants at one FFT length: JAX's noise-RDM plan on
    D [V, P] and its L, the port's stages, the signal factors of TARGETS."""
    fft_len = request.param
    jcfg, tcfg = _cfgs(fft_len)
    jpre = j_precompute(jcfg)
    mtd = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num, fft_len)
    jplan = j_rdm_plan(jpre, mtd, jcfg.sig.prt_num, tile=128, lane=128)
    l_np = j_noise_factor(j_weff(jpre.dbf_w, jcfg.dbf_variant))
    tpre = from_numpy(jpre._asdict())
    tl = make_lowrank_stages(tcfg, tpre, device="cpu")
    assert tl.rplan.n_dop == jplan.n_dop == fft_len != tl.rplan.n_pulses
    np.testing.assert_array_equal(tl.rplan.d.numpy(),
                                  mtd.astype(np.complex64))
    return dict(fft_len=fft_len, jpre=jpre, tpre=tpre, jplan=jplan,
                l_np=l_np, tl=tl,
                factors=tl.signal_factors(TargetBatch.make(*TARGETS)))


def _rows(t):
    host = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    valid = host(t.valid)
    return np.stack([host(getattr(t, f))[valid] for f in FIELDS],
                    1).astype(np.float64)


def _assert_same_targets(got, want, **kw):
    """Rows of ``got`` paired with the nearest row of ``want`` in (range,
    velocity), then compared."""
    a, b = _rows(got), _rows(want)
    assert a.shape == b.shape
    dist = (np.abs(a[:, None, 0] - b[None, :, 0])
            + 10 * np.abs(a[:, None, 1] - b[None, :, 1]))
    pair = np.argmin(dist, axis=1)
    assert len(set(pair.tolist())) == len(pair)
    np.testing.assert_allclose(a, b[pair], **kw)


@pytest.mark.parametrize("dist", ["normal", "uniform"])
def test_pallas_route_frame_matches_jax(setup, dist):
    """The "pallas" route's frame at V != P vs JAX's frame, on the planes
    JAX drew."""
    jcfg, tcfg = _cfgs(setup["fft_len"], noise_rdm_impl="pallas",
                       noise_dist=dist)
    jpre = setup["jpre"]
    key = jax.random.PRNGKey(6)
    want = j_make(jcfg, jpre)(key, JTargets.make(*TARGETS))
    jl = j_lowrank(jcfg, jpre, j_make_plan(jpre), j_matmul_plan(jpre),
                   j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num,
                                jcfg.mtd_fft_len),
                   jpre.mtd_win, jnp.complex64)
    xrs, xis = jl.noise_planes(key, interpret=True)
    num_p = jcfg.sig.prt_num
    got = make_frame_processor(tcfg, setup["tpre"], device="cpu")(
        0, TargetBatch.make(*TARGETS), noise_planes=[
            (torch.from_numpy(np.array(xr)[:, :num_p]),
             torch.from_numpy(np.array(xi)[:, :num_p]))
            for xr, xi in zip(xrs, xis)])
    assert int(got.num_final) == int(want.num_final) >= 2
    _assert_same_targets(got.targets, want.targets, rtol=1e-4)


def test_noise_rdm_matches_jax_planes_kernel(setup):
    """The noise-only RDM [B, V, G] of K1's planes mode (plain) vs JAX's
    planes kernel (interpret, f32 multiply) on the same planes."""
    jplan, tl = setup["jplan"], setup["tl"]
    rng = np.random.default_rng(11)
    planes, xrs, xis = [], [], []
    for seg, jseg in zip(tl.rplan.segments, jplan.segments):
        shape = (5, tl.rplan.n_pulses, seg.xlen)
        xr, xi = (rng.standard_normal(shape).astype(np.float32)
                  * np.float32(np.sqrt(0.5)) for _ in range(2))
        xr[..., :seg.pad_front] = xi[..., :seg.pad_front] = 0.0
        planes.append((torch.from_numpy(xr), torch.from_numpy(xi)))
        pad = ((0, 0), (0, jplan.p_pad - shape[1]),
               (0, segment_buffer_len(jseg) - seg.xlen))
        xrs.append(jnp.asarray(np.pad(xr, pad)))
        xis.append(jnp.asarray(np.pad(xi, pad)))
    want = noise_rdm_pallas_planes(xrs, xis, jplan, setup["l_np"],
                                   interpret=True, mul_dtype=jnp.float32)
    got = nr.noise_rdm(tl.rplan, tl.l_factor, planes=planes, layout="bvg")
    assert tuple(got.shape) == (5, setup["fft_len"], tl.rplan.n_gates)
    _held(got.permute(1, 2, 0), want, 1e-5, cell=1e-4)


@pytest.fixture(scope="module")
def jax_rolling(setup):
    """JAX's rolling kernel at bf16 operands with the signal fused and its
    maps, f32 output (one interpret-mode call), and the port's bf16 rows of
    the planes that kernel draws."""
    seed = jnp.asarray((3, 5), jnp.int32)
    jplan, l_np = setup["jplan"], setup["l_np"]
    xrs, xis = gen_noise_planes_pallas(seed, jplan, l_np.shape[0], A,
                                       interpret=True,
                                       mul_dtype=jnp.bfloat16)
    sig = tuple(jnp.asarray(f.numpy()) for f in setup["factors"])
    rdm, maps = noise_rdm_pallas_gen(seed, jplan, l_np, A, interpret=True,
                                     mul_dtype=jnp.bfloat16,
                                     out_dtype=jnp.float32, rolling=True,
                                     signal=sig, emit_maps=True)
    num_p = setup["tl"].rplan.n_pulses
    planes = [(torch.from_numpy(np.asarray(xr, np.float32)[:, :num_p]),
               torch.from_numpy(np.asarray(xi, np.float32)[:, :num_p]))
              for xr, xi in zip(xrs, xis)]
    return np.array(rdm), np.array(maps), planes


@pytest.mark.parametrize("emit_maps", [False, True])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_k1_bf16_matches_jax_rolling_kernel(setup, jax_rolling, out,
                                            emit_maps):
    """Plain K1 at bf16 operands with the rank-K signal at V != P vs JAX's
    rolling kernel at ``mul_dtype=bfloat16`` on the planes it draws; the
    maps [B - 1, V8, padded gates] with their interior held, V's padded
    rows zero."""
    tl = setup["tl"]
    want, want_maps, planes = jax_rolling
    tout, hold = {"f32": (torch.float32, 1e-4),
                  "bf16": (BF, 2e-4)}[out]
    if out == "bf16":
        want = nr.round_mul(torch.from_numpy(want), BF).numpy()
    got = nr.noise_rdm(tl.rplan, tl.l_factor, setup["factors"],
                       planes=planes, layout="vgb", mul_dtype=BF,
                       out_dtype=tout, emit_maps=emit_maps)
    if emit_maps:
        got, maps = got
        num_v, num_g = tl.rplan.n_dop, tl.rplan.n_gates
        assert tuple(maps.shape) == (
            4, -(-num_v // 8) * 8,
            -(-num_g // ck.GATE_TILE) * ck.GATE_TILE + 2 * ck.HALO)
        assert not maps[:, num_v:].any()
        _held(maps[:, :num_v, ck.HALO:ck.HALO + num_g], want_maps, 1e-4)
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == (setup["fft_len"], tl.rplan.n_gates, 5)
    _held(got, want, hold)


@pytest.fixture(scope="module")
def trial_pair(setup):
    """The perf stream's trial functions (rank-K xla route, V Doppler
    bins) of both packages and JAX's per-trial white z."""
    over = {"noise_rdm_impl": "xla", "noise_dist": "normal",
            "noise_prng": "threefry"}
    jcfg, tcfg = _cfgs(setup["fft_len"], **over)
    jpre = setup["jpre"]
    keys = jax.random.split(jax.random.PRNGKey(3), TRIALS)
    jl = j_lowrank(jcfg, jpre, j_make_plan(jpre), j_matmul_plan(jpre),
                   j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num,
                                jcfg.mtd_fft_len),
                   jpre.mtd_win, jnp.complex64)
    return dict(jfn=j_trial_fn(jcfg, jpre, jnp.complex64), keys=keys,
                tfn=make_trial_fn(tcfg, setup["tpre"], device="cpu"),
                noise=[np.array(jl.gen_noise(k)) for k in keys])


@pytest.mark.parametrize("snr", [20.0, -45.0])
def test_perf_trials_match_jax_on_its_draws(trial_pair, snr):
    """The perf stream's trials vs JAX's trial function, the port fed
    JAX's draws: hits equal, angles of hit trials rtol 1e-4."""
    truth = ([3000.0], [15.0], [10.0], [snr])
    ja, jh = trial_pair["jfn"](JTargets.make(*truth), trial_pair["keys"])
    ta, th = trial_pair["tfn"](TargetBatch.make(*truth), range(TRIALS),
                               noise=trial_pair["noise"])
    jh = np.asarray(jh)
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_allclose(ta.numpy()[jh], np.asarray(ja)[jh], rtol=1e-4)
    assert np.all(np.isnan(ta.numpy()[~jh]))
    if snr > 0:
        assert jh.all()


def test_pallas_prng_route_detects_truth(setup):
    """The "pallas_prng" route (K1 draws its own noise, the signal fused)
    at V != P finds the truth on the CPU, through the plain versions."""
    _, tcfg = _cfgs(setup["fft_len"])
    before = nr.launch_count
    res = make_frame_processor(tcfg, setup["tpre"], device="cpu")(
        7, TargetBatch.make([3000.0], [15.0], [10.0], [20.0]))
    assert nr.launch_count == before
    t = res.targets
    r, v = t.range_m[t.valid].numpy(), t.velocity_ms[t.valid].numpy()
    assert int(res.num_final) >= 1
    near = np.argmin(np.abs(r - 3000.0))
    assert abs(r[near] - 3000.0) < 2 * tcfg.sig.c / tcfg.sig.fs / 2
    assert abs(v[near] - 15.0) < 2 * tcfg.sig.v_max / setup["fft_len"]
