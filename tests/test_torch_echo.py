"""PyTorch port: scenario kinematics, echo synthesis and the AWGN of the
reference stream (kernel K5's plain version), held against the JAX package.

Tolerances: scenario states float64 rtol 1e-12; synthesized cubes rtol
1e-5 of the reference's largest magnitude (f32 phases formed in the same
order; JAX delays the pulse through an FFT, the port by an exact shift).
K5's draws are Philox, not JAX's threefry, so K5 is held by the contract
of ``tests/test_pallas_noise.py``: statistics over 1e6 samples here, and
shape, dtype and refusals against JAX's kernel in interpret mode."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops.dbf import dbf_weights_effective_np as j_weff
from radar_tpu.ops.pallas_noise import add_noise_pallas
from radar_tpu.sim import echo as jecho
from radar_tpu.sim import scenario as jscen
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops.awgn import awgn, awgn_plain
from radar_tpu_torch.sim import echo as techo
from radar_tpu_torch.sim import scenario as tscen
from radar_tpu_torch.waveform.precompute import from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])


def _close(got, want, rtol=1e-5):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jparams.small_test_config(), tparams.small_test_config()
    jpre = j_precompute(jcfg)
    return jcfg, tcfg, jpre, from_numpy(jpre._asdict())


@pytest.mark.parametrize("kinematics", ["altitude", "simple"])
@pytest.mark.parametrize("scene", ["default_two_target_scene",
                                   "five_target_scene"])
def test_scenario_steps_match_jax(kinematics, scene):
    jcfg, tcfg = jparams.small_test_config(), tparams.small_test_config()
    js = jscen.Scenario.from_initial(getattr(jscen, scene)(), jcfg,
                                     kinematics)
    ts = tscen.Scenario.from_initial(getattr(tscen, scene)(), tcfg,
                                     kinematics)
    for _ in range(30):
        a, b = ts.step(tcfg), js.step(jcfg)
        for f in tscen.TargetBatch._fields:
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-12, err_msg=f)
        assert ts.azimuth_deg == pytest.approx(js.azimuth_deg, rel=1e-12)


def test_scenes_and_refusal_match_jax():
    for name in ("default_two_target_scene", "five_target_scene"):
        for a, b in zip(getattr(tscen, name)(), getattr(jscen, name)()):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="kinematics"):
        tscen.Scenario.from_initial(tscen.default_two_target_scene(),
                                    tparams.small_test_config(), "ballistic")


def test_radar_equation_amplitude_matches_jax():
    r = np.array([1000.0, 3000.0, 12000.0])
    rcs = np.array([1.0, 5.0, 0.1])
    got = techo.radar_equation_amplitude(r, rcs, 0.0317)
    want = jecho.radar_equation_amplitude(jnp.asarray(r), jnp.asarray(rcs),
                                          0.0317)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("amplitudes", [None, "radar"])
def test_synthesize_echoes_matches_jax(setup, amplitudes):
    jcfg, tcfg, jpre, tpre = setup
    amp = (None if amplitudes is None else techo.radar_equation_amplitude(
        np.asarray(TARGETS[0]), np.array([2.0, 4.0]), jcfg.sig.wavelength))
    want = jecho.synthesize_echoes(jscen.TargetBatch.make(*TARGETS), jpre,
                                   jcfg, dtype=jnp.complex64,
                                   amplitudes=amp)
    got = techo.synthesize_echoes(tscen.TargetBatch.make(*TARGETS), tpre,
                                  tcfg, device="cpu", amplitudes=amp)
    assert got.dtype == torch.complex64
    _close(got, want)


def test_synthesize_echo_beams_matches_jax(setup):
    jcfg, tcfg, jpre, tpre = setup
    mix = np.ascontiguousarray(j_weff(jpre.dbf_w, jcfg.dbf_variant).T)
    want = jecho.synthesize_echo_beams(jscen.TargetBatch.make(*TARGETS),
                                       jpre, jcfg, mix, dtype=jnp.complex64)
    got = techo.synthesize_echo_beams(tscen.TargetBatch.make(*TARGETS),
                                      tpre, tcfg, mix, device="cpu")
    _close(got, want)


def test_add_noise_beamspace_matches_jax(setup):
    """Beam-space AWGN on JAX's own white draws (``white_complex_noise``
    reproduces the draws ``add_noise_beamspace`` makes from one key)."""
    jcfg, _, jpre, _ = setup
    w_eff = j_weff(jpre.dbf_w, jcfg.dbf_variant)
    l_np = jecho.beam_noise_factor(w_eff)
    rng = np.random.default_rng(2)
    shape = (4, 300, l_np.shape[0])
    beams = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
    key = jax.random.PRNGKey(9)
    want = jecho.add_noise_beamspace(key, jnp.asarray(beams), l_np)
    z = np.array(jecho.white_complex_noise(key, shape))
    got = techo.add_noise_beamspace(torch.from_numpy(beams),
                                    techo.beam_noise_factor(w_eff),
                                    torch.from_numpy(z))
    _close(got, want)


def test_white_complex_noise_and_add_noise():
    """torch.randn draws: CN(0,1) (rails N(0, 1/2)), keyed by the
    generator, AWGN scaled by sqrt(p_noise)."""
    gen = lambda s: torch.Generator().manual_seed(s)
    z = techo.white_complex_noise((200, 5000), gen(1), device="cpu")
    assert z.dtype == torch.complex64
    for rail in (z.real, z.imag):
        assert abs(float(rail.mean())) < 5 * (0.5 / z.numel()) ** 0.5
        assert abs(float(rail.var()) / 0.5 - 1) < 0.01
    assert torch.equal(z, techo.white_complex_noise((200, 5000), gen(1),
                                                    device="cpu"))
    x = torch.full((100, 1000), 2.0 - 1.0j, dtype=torch.complex64)
    y = techo.add_noise(x, gen(2), p_noise=4.0)
    assert abs(float((y - x).real.var()) / 2.0 - 1) < 0.02


# ------------------------------------------------------------------- K5


@pytest.fixture(scope="module")
def k5_draws():
    """K5's plain version on a zero cube of 1e6 complex samples."""
    x = torch.zeros((250, 1000, 4), dtype=torch.complex64)
    return awgn_plain(x, (11, 22)).reshape(-1)


def test_k5_plain_rail_statistics(k5_draws):
    """The contract of tests/test_pallas_noise.py:55-72 over 1e6 samples:
    per-rail mean within 5 sigma, variance 0.5 +- 1%, kurtosis 3 +- 0.05,
    lag-1 and re*im correlation below 5e-3."""
    n = k5_draws.numel()
    re, im = k5_draws.real.double(), k5_draws.imag.double()
    for rail in (re, im):
        assert abs(float(rail.mean())) < 5 * (0.5 / n) ** 0.5
        var = float(rail.var())
        assert abs(var / 0.5 - 1) < 0.01
        c = rail - rail.mean()
        assert abs(float((c**4).mean() / var**2) - 3.0) < 0.05
        assert abs(float((c[1:] * c[:-1]).mean() / var)) < 5e-3
    assert abs(float((re * im).mean() / 0.5)) < 5e-3


def test_k5_plain_is_keyed_and_passes_signal_through(k5_draws):
    x = torch.zeros((250, 1000, 4), dtype=torch.complex64)
    again = awgn(x, (11, 22)).reshape(-1)
    assert torch.equal(again, k5_draws)
    other = awgn(x, (12, 22)).reshape(-1)
    assert float((other == k5_draws).float().mean()) < 1e-4
    sig = torch.complex(torch.linspace(-3, 3, 1_000_000),
                        torch.linspace(5, -5, 1_000_000)).reshape(x.shape)
    y = awgn(sig, (11, 22)).reshape(-1)
    torch.testing.assert_close(y - k5_draws, sig.reshape(-1), rtol=0,
                               atol=2e-6)
    odd = torch.zeros(7, dtype=torch.complex64)        # odd sample count
    torch.testing.assert_close(awgn(odd, (11, 22)), k5_draws[:7])


def test_k5_matches_jax_kernel_interface():
    """Shape, dtype and refusals as JAX's add_noise_pallas (interpret
    mode, whose generator is not meaningful)."""
    x = np.zeros((16, 64, 4), np.complex64) + (3.0 - 2.0j)
    want = add_noise_pallas(jax.random.PRNGKey(0), jnp.asarray(x),
                            p_noise=1.0, interpret=True)
    got = awgn(torch.from_numpy(x), (0, 0), p_noise=1.0)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert torch.isfinite(torch.view_as_real(got)).all()
    assert not torch.equal(got, torch.from_numpy(x))
    with pytest.raises(ValueError):
        add_noise_pallas(jax.random.PRNGKey(0), jnp.zeros((8, 128)),
                         interpret=True)
    with pytest.raises(ValueError, match="complex64"):
        awgn(torch.zeros((8, 128)), (0, 0))
    with pytest.raises(ValueError, match="complex64"):
        awgn(torch.zeros((8, 128), dtype=torch.complex128), (0, 0))


def test_k5_noise_power_follows_p_noise():
    x = torch.zeros(200_000, dtype=torch.complex64)
    y = awgn(x, (1, 2), p_noise=9.0)
    for rail in (y.real, y.imag):
        assert abs(float(rail.var()) / 4.5 - 1) < 0.02
