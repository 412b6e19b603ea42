"""Monte-Carlo SNR sweep: monopulse angle-error sigma and detection
probability vs SNR — port of ``radar_tpu/pipeline/montecarlo.py``
(reference main_plot_snr_vs_angle_error.m).

The noiseless echo is synthesized once per SNR point (the rank-K signal
RDM on the perf stream, the beam cube on the fused stream, the raw channel
cube on the reference stream) and only the noise and processing chain runs
per trial, through the frame's own stages (``pipeline/frame.py::
make_frame_stages``). Trials run as a loop on one stream, as JAX's
``lax.map`` does for its kernel routes; each trial's angle and hit stay on
the device and a batch is copied to the host once. The reference stream's
trials draw their AWGN with ``torch.randn`` whatever ``noise_impl`` says,
as JAX's trial function calls ``add_noise``; the perf stream's
``"pallas_prng"`` route runs kernel K1 noise-only. The trials' tail honours
``tail_from_rdm``, the monopulse flags, ``cluster.keep_pair_mode`` and
``cfar.means_impl`` and, as JAX's ``make_trial_fn`` does, disregards
``kernel_maps`` and ``beams_major_tail`` (``make_frame_stages(trials=
True)``).

Per trial the recorded statistic follows the reference (:269-278): the
*first* final target's angle error vs truth, NaN when nothing is detected;
per SNR point: std('omitnan') of the errors and Pd = detection fraction.
The analytic reference bound is sigma = |k|*sqrt(2)/sqrt(SNR_lin)
(:303-309).

Trial seeds: trial ``t`` at SNR index ``i`` takes the integer seed
``pipeline/driver.py::trial_seed(seed, i, t)``, whatever the batch size.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config.params import RadarConfig
from ..sim.scenario import TargetBatch
from ..waveform.precompute import Precomputed, precompute
from .driver import trial_seed
from .frame import make_frame_stages


class SweepResult(NamedTuple):
    snr_db: np.ndarray
    angle_error_std: np.ndarray   # [n_snr] degrees, std over detected trials
    detection_probability: np.ndarray
    errors: np.ndarray            # [n_snr, trials] raw errors (NaN = miss)
    theory_bound: np.ndarray      # |k|*sqrt(2)/sqrt(SNR_lin)


def _first_valid_angle(result):
    """Angle of the first valid final-target slot (the reference reads
    final_targets(1), ref :271-274), NaN if none; and whether there is
    one. Both stay on the device."""
    t = result.targets
    has = t.valid.any()
    first = t.valid.to(torch.uint8).argmax()        # first True
    nan = torch.full((), float("nan"), dtype=t.angle_deg.dtype,
                     device=t.angle_deg.device)
    return torch.where(has, t.angle_deg[first], nan), has


def make_trial_fn(cfg: RadarConfig, precomp: Precomputed | None = None, *,
                  device="cuda"):
    """Returns ``trials(targets, seeds, noise=None, noise_planes=None) ->
    (angles [T], hits [T])``, tensors on ``device`` (the card by default):
    one echo synthesis, then the noise and processing chain of each trial
    seed in turn.

    ``noise`` (T per-trial cubes: channel AWGN on the reference stream,
    white beam noise on the fused stream, white z on the perf stream's xla
    route) or ``noise_planes`` (T per-trial plane lists, the perf stream's
    kernel routes) replace the draws, so tests can feed JAX's own."""
    if precomp is None:
        precomp = precompute(cfg)
    st = make_frame_stages(cfg, precomp, device=device, trials=True)
    lr = st.lowrank

    def trials(targets: TargetBatch, seeds, noise=None, noise_planes=None):
        seeds = [int(s) for s in seeds]
        for name, inj in (("noise", noise), ("noise_planes", noise_planes)):
            if inj is not None and len(inj) != len(seeds):
                raise ValueError(f"{name}= needs one entry per trial seed")
        if lr is not None:
            echo = lr.signal_rdm(targets, lr.rdm_layout)
        else:
            echo = st.synth(targets)
        angles, hits = [], []
        for t, seed in enumerate(seeds):
            z = None if noise is None else noise[t]
            if lr is not None:
                rdm = lr.noisy_rdm(echo, seed, z, None if noise_planes is None
                                   else noise_planes[t])
                layout = lr.rdm_layout
            else:
                if noise_planes is not None:
                    raise ValueError("noise_planes= drives the rank-K perf "
                                     "stream only; this stream takes noise=")
                rdm = st.chain(echo, seed, z, kernel_noise=False)[-1]
                layout = "vgb"
            angle, hit = _first_valid_angle(st.detect(rdm, layout)[-1])
            angles.append(angle)
            hits.append(hit)
        return torch.stack(angles), torch.stack(hits)

    return trials


def true_pair_index(precomp: Precomputed, elevation_deg: float) -> int:
    """The beam pair whose interval contains the truth elevation."""
    a = precomp.beam_angles_deg
    return int(np.clip(np.searchsorted(a, elevation_deg) - 1, 0,
                       len(a) - 2))


def snr_sweep(cfg: RadarConfig, snr_db_vector=None, num_trials: int = 100,
              truth: TargetBatch | None = None,
              true_pair_idx: int | None = None, seed: int = 0,
              batch_size: int = 16, precomp: Precomputed | None = None,
              progress: bool = False, mesh=None, *,
              device="cuda") -> SweepResult:
    """Run the sweep on ``device`` (the card by default). Defaults mirror
    the reference: SNR -10..30 dB step 2, truth target R=10 km, V=20 m/s,
    El=10 deg (beam pair index 5, 0-based).

    ``mesh``: a ``parallel.mesh.Mesh`` with a ``dp`` axis, on every rank:
    each trial batch is sharded over dp (``parallel/dp.py::
    make_dp_trial_fn``, the reference's ``parfor`` boundary,
    main_plot_snr_vs_angle_error.m:167, mapped onto ranks), trials run on
    the mesh's device and every rank returns the whole sweep, equal to the
    one-rank sweep trial for trial. ``batch_size`` and ``num_trials`` must
    be multiples of the dp size."""
    if snr_db_vector is None:
        snr_db_vector = np.arange(-10.0, 30.0 + 1e-9, 2.0)
    snr_db_vector = np.asarray(snr_db_vector, np.float64)
    if precomp is None:
        precomp = precompute(cfg)
    if truth is None:
        truth = TargetBatch.make([10000.0], [20.0], [10.0], [0.0])
    if true_pair_idx is None:
        true_pair_idx = true_pair_index(precomp, truth.elevation_deg[0])
    k_slope = float(precomp.k_slopes_lut[true_pair_idx])

    if mesh is not None:
        from ..parallel.dp import make_dp_trial_fn
        from ..parallel.mesh import AXIS_DP, check_mesh

        n_dp = check_mesh(mesh).shape[AXIS_DP]
        if batch_size % n_dp or num_trials % n_dp:
            raise ValueError(
                f"batch_size={batch_size} and num_trials={num_trials} must "
                f"be multiples of the dp axis size {n_dp}")
        trials_fn = make_dp_trial_fn(cfg, mesh, precomp)
        progress = progress and mesh.rank == 0
    else:
        trials_fn = make_trial_fn(cfg, precomp, device=device)
    errors = np.full((len(snr_db_vector), num_trials), np.nan)
    for i, snr in enumerate(snr_db_vector):
        tb = TargetBatch(truth.range_m, truth.velocity_ms,
                         truth.elevation_deg,
                         np.full_like(truth.range_m, snr))
        done = 0
        while done < num_trials:
            nb = min(batch_size, num_trials - done)
            seeds = [trial_seed(seed, i, done + t) for t in range(nb)]
            angles, hits = trials_fn(tb, seeds)
            angles = angles.cpu().numpy().astype(np.float64)
            hits = hits.cpu().numpy()
            errors[i, done:done + nb] = np.where(
                hits, angles - float(truth.elevation_deg[0]), np.nan)
            done += nb
        if progress:
            pd = np.mean(~np.isnan(errors[i]))
            print(f"SNR {snr:+.0f} dB: Pd={pd:.2f} "
                  f"sigma={np.nanstd(errors[i], ddof=1):.4f} deg")

    with np.errstate(invalid="ignore"):
        sigma = np.array([np.nanstd(e, ddof=1) if np.sum(~np.isnan(e)) > 1
                          else np.nan for e in errors])
    pd = np.mean(~np.isnan(errors), axis=1)
    snr_lin = 10.0 ** (snr_db_vector / 10.0)
    theory = np.abs(k_slope) * np.sqrt(2.0) / np.sqrt(snr_lin)
    return SweepResult(snr_db_vector, sigma, pd, errors, theory)
