"""PyTorch port: the CFAR false-alarm calibration (``ops/cfar_analysis.py``)
and ``utils/stats.py::wilson_ci`` held against the JAX package: the
analytic Pfa functions equal JAX's (the same scipy quadrature, rtol
1e-12); the exceedance counters give JAX's counts exactly on identical
maps (their thresholds are bit for bit jitted JAX's); the port's own
measured counts on iid exponential cells sit in a 4-sigma Poisson band of
the analytic rate (as ``tests/test_pfa.py``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config.params import Cfar1DParams as JCfar1D
from radar_tpu.config.params import CfarParams as JCfar
from radar_tpu.ops import cfar_analysis as ja
from radar_tpu.utils.stats import wilson_ci as j_wilson

from radar_tpu_torch.config.params import Cfar1DParams, CfarParams
from radar_tpu_torch.ops import cfar_analysis as ta
from radar_tpu_torch.utils.stats import wilson_ci

TS = [1.5, 4.0, 6.0, 8.0]


@pytest.mark.parametrize("t", [2.0, 4.0, 8.0, 12.0])
def test_analytic_pfa_equals_jax(t):
    for n in (5, 16):
        for comb in ("CA", "GO", "SO"):
            assert ta.analytic_pfa_exponential(t, [n, n], comb) == \
                pytest.approx(ja.analytic_pfa_exponential(t, [n, n], comb),
                              rel=1e-12)
        assert ta.analytic_pfa_ca_closed_form(t, 2 * n) == pytest.approx(
            ja.analytic_pfa_ca_closed_form(t, 2 * n), rel=1e-12)
        assert ta.analytic_pfa_go_closed_form(t, n) == pytest.approx(
            ja.analytic_pfa_go_closed_form(t, n), rel=1e-12)
        # the quadrature against the closed forms (tests/test_pfa.py:31)
        assert abs(ta.analytic_pfa_exponential(t, [n, n], "GO")
                   / ta.analytic_pfa_go_closed_form(t, n) - 1) < 1e-3
    for method in ("GOCA", "CA"):
        assert ta.analytic_pfa_goca2d(t, CfarParams(method=method)) == \
            pytest.approx(ja.analytic_pfa_goca2d(t, JCfar(method=method)),
                          rel=1e-12)


def _exp_maps(seed, shape):
    return np.random.default_rng(seed).exponential(size=shape).astype(
        np.float32)


def test_count_exceedances_2d_equals_jax():
    maps = _exp_maps(0, (96, 300, 3))
    c, n = ta.count_exceedances_2d(torch.from_numpy(maps), CfarParams(), TS)
    jcnt, jn = jax.jit(lambda m: ja.count_exceedances_2d(m, JCfar(), TS))(
        jnp.asarray(maps))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jcnt))
    assert int(n) == int(jn) and c.dtype == torch.int32


@pytest.mark.parametrize("method,ref", [("GO", 16), ("CA", 7)])
def test_count_exceedances_1d_interior_equals_jax(method, ref):
    x = _exp_maps(1, (64, 500))
    kw = dict(method=method, ref_cells=ref)
    c, n = ta.count_exceedances_1d_interior(torch.from_numpy(x),
                                            Cfar1DParams(**kw), TS)
    jcnt, jn = jax.jit(lambda m: ja.count_exceedances_1d_interior(
        m, JCfar1D(**kw), TS))(jnp.asarray(x))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jcnt))
    assert int(n) == int(jn)


@pytest.mark.parametrize("num_v", [64, 65])
def test_count_exceedances_realdata_equals_jax(num_v):
    maps = _exp_maps(2, (num_v, 3404, 2))
    splits, dvb = (228, 723, 2453), 0.45
    c, n = ta.count_exceedances_realdata(torch.from_numpy(maps),
                                         Cfar1DParams(), splits, dvb,
                                         torch.tensor(TS))
    jcnt, jn = jax.jit(lambda m: ja.count_exceedances_realdata(
        m, JCfar1D(), splits, dvb, TS))(jnp.asarray(maps))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jcnt))
    assert int(n) == int(jn)


def test_cfar1d_measured_matches_analytic():
    """The port's 1D GO CFAR (interior cells) on iid exponential cells
    matches Gandhi & Kassam within a 4-sigma Poisson band."""
    p = Cfar1DParams()
    x = torch.from_numpy(_exp_maps(3, (600, 1200)))
    c, n = ta.count_exceedances_1d_interior(x, p, [4.0, 6.0])
    for t, hits in zip([4.0, 6.0], c.tolist()):
        want = ta.analytic_pfa_go_closed_form(t, p.ref_cells) * int(n)
        assert abs(hits - want) <= 4.0 * np.sqrt(want), (t, hits, want)


@pytest.mark.parametrize("k,n", [(0, 200), (142, 200), (200, 200),
                                 (3, 17)])
def test_wilson_ci_equals_jax(k, n):
    assert wilson_ci(k, n) == j_wilson(k, n)
    lo, hi = wilson_ci(k, n)
    assert 0.0 <= lo <= k / n <= hi <= 1.0 + 1e-12
