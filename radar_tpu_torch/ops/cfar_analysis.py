"""CFAR false-alarm-rate calibration: analytic Pfa expectations and
measured-exceedance counters for both CFAR families — port of
``radar_tpu/ops/cfar_analysis.py``.

The reference fixes ``T_CFAR = 8`` (fun_process_single_frame.m:178-205)
and never measures its false-alarm rate. Two kinds of evidence:

1. **Analytic** (:func:`analytic_pfa_exponential`, scipy on the host): for
   iid unit-exponential cells every detector here is a mean-normalized
   CFAR whose noise statistic is a max/min/average of means of disjoint
   reference windows, independent Gamma(n, 1/n) variates, so

       Pfa(T) = E[exp(-T * C)] = T * Integral_0^inf exp(-T m) F_C(m) dm

   with F_C the order-statistic CDF; the CA closed form and Gandhi &
   Kassam's GO form (1988) cross-check the quadrature.

2. **Measured** (the counters, on the maps' device): the operational
   compares of the 2D GOCA (``>``, border cells excluded) and of the
   segmented 1D CFAR (``>=``, edge fallback, clutter band excluded) swept
   over a vector of threshold factors from one noise estimate.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import special

from ..config.params import Cfar1DParams, CfarParams
from .cfar import goca_noise_and_valid
from .cfar1d import _segment_noise_1d, zero_velocity_mask

# ---------------------------------------------------------------------------
# analytic expectations (iid unit-exponential cells, mean-normalized CFAR)
# ---------------------------------------------------------------------------


def _gamma_mean_cdf(m: np.ndarray, n: int) -> np.ndarray:
    """CDF of the mean of n iid unit-exponential cells = Gamma(n, 1/n)."""
    return special.gammainc(n, n * m)


def _combined_cdf(m: np.ndarray, windows, combine: str) -> np.ndarray:
    """CDF of combine(window means) on the grid ``m``.

    ``windows``: iterable of ints, cells per disjoint reference window.
    ``combine``: "GO" (max), "SO" (min), or "CA" (average; equal-size
    windows only — the average of equal-scale Gammas is itself Gamma).
    """
    windows = list(windows)
    if combine == "CA":
        if len(set(windows)) != 1:
            raise ValueError("CA merge needs equal-size windows")
        return _gamma_mean_cdf(m, sum(windows))
    cdfs = np.stack([_gamma_mean_cdf(m, n) for n in windows])
    if combine == "GO":
        return np.prod(cdfs, axis=0)
    if combine == "SO":
        return 1.0 - np.prod(1.0 - cdfs, axis=0)
    raise ValueError(f"unknown combine: {combine}")


def analytic_pfa_exponential(t_factor: float, windows, combine: str,
                             grid_points: int = 400_000) -> float:
    """Exact Pfa of ``x > T * combine(window means)`` for an iid
    unit-exponential cell under test and disjoint reference windows,
    by quadrature of  T * Integral exp(-T m) F_C(m) dm  (integration by
    parts of E[exp(-T C)]; the tail beyond the grid where F_C ~= 1
    contributes exp(-T m_max), added analytically)."""
    m_max = max(20.0, 200.0 / t_factor)
    m = np.linspace(0.0, m_max, grid_points)
    f = _combined_cdf(m, windows, combine)
    body = t_factor * np.trapezoid(np.exp(-t_factor * m) * f, m)
    return float(body + np.exp(-t_factor * m_max))


def analytic_pfa_goca2d(t_factor: float, params: CfarParams) -> float:
    """The sim-path 2D cross detector on iid exponential cells: noise =
    max over the four disjoint window means (lead/trail x range/Doppler)
    for method GOCA; CA per dim merges each dim's two windows first."""
    if params.method == "GOCA":
        win = [params.ref_cells_r, params.ref_cells_r,
               params.ref_cells_v, params.ref_cells_v]
        return analytic_pfa_exponential(t_factor, win, "GO")
    if params.method == "CA":
        win = [2 * params.ref_cells_r, 2 * params.ref_cells_v]
        return analytic_pfa_exponential(t_factor, win, "GO")
    raise ValueError(f"no analytic form wired for method {params.method}")


def analytic_pfa_ca_closed_form(t_factor: float, n_cells: int) -> float:
    """Textbook CA-CFAR closed form (mean-normalized): (1 + T/N)^-N.
    Used as an independent cross-check of the quadrature."""
    return float((1.0 + t_factor / n_cells) ** (-n_cells))


def analytic_pfa_go_closed_form(t_factor: float, n_half: int) -> float:
    """Gandhi & Kassam (1988) GO-CFAR closed form, mean-normalized with
    two n-cell half-windows:
      Pfa = 2(1+t)^-n - 2 sum_{k=0}^{n-1} C(n+k-1, k) (2+t)^-(n+k),
    with t = T/n (per-sum multiplier). Cross-checks the quadrature."""
    t = t_factor / n_half
    n = n_half
    s = sum(special.comb(n + k - 1, k, exact=True) * (2.0 + t) ** -(n + k)
            for k in range(n))
    return float(2.0 * (1.0 + t) ** -n - 2.0 * s)


# ---------------------------------------------------------------------------
# measured exceedance counters (on the maps' device; counts over a T grid)
# ---------------------------------------------------------------------------


def _ts(t_factors, like: torch.Tensor) -> torch.Tensor:
    """The threshold factors as a [T, 1, ...] tensor ahead of ``like``."""
    if not isinstance(t_factors, torch.Tensor):
        t_factors = torch.as_tensor(np.asarray(t_factors))
    ts = t_factors.to(device=like.device, dtype=like.dtype)
    return ts.reshape((-1,) + (1,) * like.ndim)


def count_exceedances_2d(maps: torch.Tensor, params: CfarParams,
                         t_factors) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-threshold-factor false-alarm counts of the sim-path 2D detector
    on (noise-only) pair-sum maps [V, G, pairs]: (counts [T] int32,
    n_valid int32). One noise map; the T sweep is a broadcast compare, the
    operational ``maps > T*noise`` on border-valid cells."""
    noise, valid = goca_noise_and_valid(maps, params)
    valid = valid.expand(maps.shape)
    hits = (maps[None] > _ts(t_factors, maps) * noise[None]) & valid[None]
    counts = hits.sum(dim=(1, 2, 3), dtype=torch.int32)
    return counts, valid.sum(dtype=torch.int32)


def count_exceedances_1d_interior(x: torch.Tensor, params: Cfar1DParams,
                                  t_factors) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Interior-cell (no edge fallback) counts of one 1D CFAR segment on
    noise-only data [V, G(, pairs)], the cells the analytic form models,
    with the operational >= compare (Function_CFAR1D_sub, debug_v2:500)."""
    noise, interior = _segment_noise_1d(x, params.guard_cells,
                                        params.ref_cells, params.method,
                                        axis=1)
    hits = (x[None] >= _ts(t_factors, x) * noise[None]) & interior[None]
    counts = hits.sum(dim=tuple(range(1, x.ndim + 1)), dtype=torch.int32)
    return counts, interior.sum(dtype=torch.int32)


def count_exceedances_realdata(maps: torch.Tensor, params: Cfar1DParams,
                               gate_splits, delta_v_bin: float,
                               t_factors) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Operational real-data-path counts: per-segment 1D CFAR with edge
    fallback and the zero-velocity clutter band excluded, the
    segmented_cfar_1d semantics swept over threshold factors. The tested
    cell count is the mask geometry's, with the reference package's
    ``round(V/2)`` center (Python's half-to-even), which differs from the
    detector's band only for odd V with even V//2."""
    num_v = maps.shape[0]
    n0v = int(params.mtd_zero_vel_ms / delta_v_bin)
    vshape = [1] * maps.ndim
    vshape[0] = num_v
    vmask = zero_velocity_mask(num_v, n0v, maps.device).reshape(vshape)
    ts = _ts(t_factors, maps)
    idx = np.arange(num_v)
    center = round(num_v / 2)
    allowed = ~((idx >= center - n0v) & (idx <= center + n0v))
    n_tested = int(allowed.sum()) * int(np.prod(maps.shape[1:]))

    counts = torch.zeros(ts.shape[0], dtype=torch.int32, device=maps.device)
    start = 0
    for width in gate_splits:
        seg = maps[:, start:start + width]
        noise, _ = _segment_noise_1d(seg, params.guard_cells,
                                     params.ref_cells, params.method,
                                     axis=1)
        hits = (seg[None] >= ts * noise[None]) & vmask[None]
        counts = counts + hits.sum(dim=tuple(range(1, maps.ndim + 1)),
                                   dtype=torch.int32)
        start += width
    return counts, torch.tensor(n_tested, dtype=torch.int32,
                                device=maps.device)
