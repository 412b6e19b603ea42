"""PyTorch port: the NumPy baseline frame (``bench/baseline_np.py``) held
against the JAX package's ``radar_tpu/bench/baseline_np.py``.

Both are float64 NumPy/SciPy on the host, each on its own package's
precomputed constants: at ``small_test_config()`` (8 channels x 32
pulses x 5819 samples), with ``bench.py``'s two targets and
``np.random.default_rng(seed)``, the detections' indices and count are
identical and their amplitudes agree to rtol 1e-12."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from radar_tpu.bench.baseline_np import frame_baseline_np as j_baseline
from radar_tpu.config import params as jparams
from radar_tpu.sim.scenario import TargetBatch as JTargetBatch
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.bench.baseline_np import frame_baseline_np
from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import precompute

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's two targets (range m, velocity m/s, elevation deg, SNR dB)
TARGETS = ([3000.0, 10000.0], [20.0, 25.0], [10.0, 10.0], [10.0, 15.0])


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jparams.small_test_config(), tparams.small_test_config()
    return (jcfg, j_precompute(jcfg), JTargetBatch.make(*TARGETS),
            tcfg, precompute(tcfg), TargetBatch.make(*TARGETS))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_baseline_frame_matches_jax(setup, seed):
    jcfg, jpre, jtruth, tcfg, tpre, ttruth = setup
    want, n_want = j_baseline(np.random.default_rng(seed), jtruth, jpre, jcfg)
    got, n_got = frame_baseline_np(np.random.default_rng(seed), ttruth, tpre,
                                   tcfg)
    assert n_got == n_want == len(got) > 0
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-12, atol=0)
    # the 3000 m truth among the detections, within 2 gates and 2 Doppler
    # bins (at 32 pulses the 25 m/s one falls in the CFAR's Doppler border)
    rng_m = tpre.range_axis[got[:, 1].astype(int)]
    vel = tpre.velocity_axis[got[:, 0].astype(int)]
    assert np.any((np.abs(rng_m - 3000.0) <= 2 * tpre.delta_r)
                  & (np.abs(vel - 20.0) <= 2 * tpre.delta_v))


def test_baseline_import_loads_neither_jax_nor_radar_tpu():
    code = ("import sys, radar_tpu_torch.bench.baseline_np; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'radar_tpu' or m.startswith('radar_tpu.') "
            "for m in sys.modules), 'radar_tpu imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
