"""PyTorch port: the Monte-Carlo SNR sweep (``pipeline/montecarlo.py``)
held against the JAX package's ``make_trial_fn`` and ``snr_sweep`` at small
widths on the CPU.

The trial functions of both packages run on the same noise: JAX draws it
from its trial keys, the test reproduces those draws and injects them into
the port (``noise=``), for the reference stream and the perf stream's xla
route. Tolerances: hits exactly equal, angles of hit trials rtol 1e-4
(estimates from f32 sums taken in another order); the sweep's theory bound
rtol 1e-12 (float64 host arithmetic on the same constants). The port's
own sweeps are held by the statistics of ``tests/test_pipeline.py``: Pd
from <= 0.3 below the transition to >= 0.9 above it."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.pulse_compression import make_matmul_plan as j_matmul_plan
from radar_tpu.ops.pulse_compression import make_plan as j_make_plan
from radar_tpu.pipeline.lowrank import make_lowrank_stages as j_lowrank
from radar_tpu.pipeline.montecarlo import make_trial_fn as j_trial_fn
from radar_tpu.pipeline.montecarlo import snr_sweep as j_snr_sweep
from radar_tpu.sim.echo import add_noise as j_add_noise
from radar_tpu.sim.scenario import TargetBatch as JTargets
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops import noise_rdm as nr
from radar_tpu_torch.pipeline.driver import trial_seed
from radar_tpu_torch.pipeline.montecarlo import (make_trial_fn, snr_sweep,
                                                 true_pair_index)
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy, precompute

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PERF = {**jparams.PERF_OVERRIDES, "matmul_precision": "f32"}
# threefry: JAX's vmapped rbg draws differ from its unbatched ones, so only
# threefry keys let the test reproduce what the JAX trial function draws
ROUTES = {"reference": {}, "lowrank_xla": {**PERF, "noise_rdm_impl": "xla",
                                           "noise_dist": "normal",
                                           "noise_prng": "threefry"}}
TRIALS = 4


@pytest.fixture(scope="module", params=list(ROUTES))
def trial_pair(request):
    """JAX's jitted trial function, the port's, and JAX's per-trial draws
    from the trial keys."""
    over = ROUTES[request.param]
    jcfg = jparams.small_test_config().replace(**over)
    tcfg = tparams.small_test_config().replace(**over)
    jpre = j_precompute(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(3), TRIALS)
    if request.param == "reference":
        shape = (jcfg.sig.prt_num, jpre.tx_pulse.shape[0],
                 jcfg.sig.channel_num)
        noise = [np.array(j_add_noise(k, jnp.zeros(shape, jnp.complex64)))
                 for k in keys]
    else:
        jl = j_lowrank(jcfg, jpre, j_make_plan(jpre), j_matmul_plan(jpre),
                       j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num),
                       jpre.mtd_win, jnp.complex64)
        noise = [np.array(jl.gen_noise(k)) for k in keys]
    return dict(jfn=j_trial_fn(jcfg, jpre, jnp.complex64), keys=keys,
                tfn=make_trial_fn(tcfg, from_numpy(jpre._asdict()),
                                  device="cpu"), noise=noise)


@pytest.mark.parametrize("snr", [20.0, -45.0])
def test_trials_match_jax_on_its_draws(trial_pair, snr):
    truth = ([3000.0], [15.0], [10.0], [snr])
    ja, jh = trial_pair["jfn"](JTargets.make(*truth), trial_pair["keys"])
    ta, th = trial_pair["tfn"](TargetBatch.make(*truth), range(TRIALS),
                               noise=trial_pair["noise"])
    assert ta.shape == th.shape == (TRIALS,) and th.dtype == torch.bool
    jh = np.asarray(jh)
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_allclose(ta.numpy()[jh], np.asarray(ja)[jh], rtol=1e-4)
    assert np.all(np.isnan(ta.numpy()[~jh]))
    if snr > 0:
        assert jh.all()


def test_sweep_constants_match_jax():
    """True pair, k slope and theory bound |k|*sqrt(2)/sqrt(SNR_lin), at
    the default truth (10 km, 10 deg) and at another elevation."""
    jcfg = jparams.small_test_config()
    tcfg = tparams.small_test_config()
    snrs = [-10.0, 5.0, 20.0]
    for truth in (None, ([4000.0], [15.0], [14.0], [0.0])):
        want = j_snr_sweep(jcfg, snr_db_vector=snrs, num_trials=1,
                           truth=None if truth is None
                           else JTargets.make(*truth), batch_size=1)
        got = snr_sweep(tcfg, snr_db_vector=snrs, num_trials=1,
                        truth=None if truth is None
                        else TargetBatch.make(*truth), batch_size=1,
                        device="cpu")
        np.testing.assert_allclose(got.theory_bound, want.theory_bound,
                                   rtol=1e-12)
        np.testing.assert_array_equal(got.snr_db, want.snr_db)
        pre = precompute(tcfg)
        el = 10.0 if truth is None else truth[2][0]
        k = float(pre.k_slopes_lut[true_pair_index(pre, el)])
        np.testing.assert_allclose(abs(k) * np.sqrt(2.0) / np.sqrt(0.1),
                                   want.theory_bound[0], rtol=1e-12)


@pytest.mark.parametrize("route", ["reference", "perf"])
def test_small_sweep_pd_rises(route):
    """After tests/test_pipeline.py::test_monte_carlo_sweep_small: Pd from
    below to above the transition (~-28 dB raw SNR here), sigma shrinking,
    the theory bound falling."""
    cfg = tparams.small_test_config(channels=8, pulses=32)
    if route == "perf":
        cfg = cfg.replace(**PERF)
    before = nr.launch_count
    res = snr_sweep(cfg, snr_db_vector=[-42.0, -28.0, 25.0], num_trials=12,
                    truth=TargetBatch.make([3000.0], [10.0], [10.0], [0.0]),
                    seed=1, batch_size=6, device="cpu")
    assert nr.launch_count == before          # the CPU runs the plain twin
    assert res.errors.shape == (3, 12)
    assert res.detection_probability[0] <= 0.3
    assert res.detection_probability[-1] >= 0.9
    assert np.isnan(res.angle_error_std[0]) or (
        res.angle_error_std[0] >= res.angle_error_std[-1])
    assert res.angle_error_std[-1] < 1.5
    assert np.all(np.diff(res.theory_bound) < 0)


def test_trial_seeds_do_not_depend_on_batch_size():
    cfg = tparams.small_test_config().replace(**PERF)
    kw = dict(snr_db_vector=[-28.0, 0.0], num_trials=5, seed=4,
              truth=TargetBatch.make([3000.0], [10.0], [10.0], [0.0]),
              device="cpu")
    a = snr_sweep(cfg, batch_size=2, **kw)
    b = snr_sweep(cfg, batch_size=5, **kw)
    np.testing.assert_array_equal(a.errors, b.errors)
    c = snr_sweep(cfg, batch_size=5, **{**kw, "seed": 5})
    assert not np.array_equal(c.errors, a.errors, equal_nan=True)


def test_trial_seed_rule():
    assert trial_seed(3, 2, 7) == (3 << 32) + (2 << 20) + 7
    assert trial_seed(-1, 0, 0) == 0xFFFFFFFF << 32
    seeds = {trial_seed(0, i, t) for i in range(4) for t in range(100)}
    assert len(seeds) == 400
    for point, trial in ((1 << 12, 0), (0, 1 << 20), (-1, 0)):
        with pytest.raises(ValueError, match="trial_seed"):
            trial_seed(0, point, trial)


def test_mesh_and_wrong_injection_are_refused():
    cfg = tparams.small_test_config()
    with pytest.raises(NotImplementedError, match="mesh"):
        snr_sweep(cfg, num_trials=1, mesh=object(), device="cpu")
    trials = make_trial_fn(cfg, device="cpu")
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [10.0])
    with pytest.raises(ValueError, match="one entry per trial"):
        trials(tb, [1, 2], noise=[None])
    with pytest.raises(ValueError, match="noise_planes"):
        trials(tb, [1], noise_planes=[[]])


@pytest.mark.parametrize("entry", ["make_trial_fn", "snr_sweep"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = tparams.small_test_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "make_trial_fn":
            make_trial_fn(cfg)
        else:
            snr_sweep(cfg, num_trials=1)
