"""PyTorch port: the DoA tools (``doa/music.py``, ``doa/superres.py``,
``doa/monopulse.py``, ``doa/calibrate.py``) held against the JAX package
on the same numpy-made snapshots.

Holds: MUSIC spectra rtol 1e-5 and noise-subspace projectors En En^H to
1e-9 (complex128; the eigenvectors themselves may differ in phase, so
they are never compared); the peaks equal (where picks tie in value, as
index sets); root-MUSIC and ESPRIT to 1e-9 deg on complex128 snapshots
(identical f64 covariances up to the matmul's rounding); the smoothed
covariances 1e-12; monopulse and calibration (host numpy, the same
arithmetic) to 1e-12; the snapshot-sharded covariance on 2 and 4 gloo
ranks to 1e-10 of the one-process covariance, with the same peaks."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import assets as jassets
from radar_tpu.doa import calibrate as jcal
from radar_tpu.doa import monopulse as jmono
from radar_tpu.doa import music as jmusic
from radar_tpu.doa import superres as jsr

from radar_tpu_torch.config import assets
from radar_tpu_torch.config.params import full_config
from radar_tpu_torch.doa import calibrate as tcal
from radar_tpu_torch.doa import monopulse as tmono
from radar_tpu_torch.doa import music as tmusic
from radar_tpu_torch.doa import superres as tsr
from radar_tpu_torch.doa.steering import steering_vector
from radar_tpu_torch.parallel import dryrun
from radar_tpu_torch.parallel.multihost import run_ranks

WL = 2.99792458e8 / 9450e6
D16 = full_config().array.element_spacing


def _ula_snapshots(truth, c, d, k, snr_db, seed, dtype=np.complex128):
    """X = A S + N, made by numpy (the model of simulate_snapshots)."""
    rng = np.random.default_rng(seed)
    a = steering_vector(np.asarray(truth), c, d, WL)
    m = len(truth)
    s = (rng.normal(size=(m, k)) + 1j * rng.normal(size=(m, k))) \
        * np.sqrt(0.5)
    n = (rng.normal(size=(c, k)) + 1j * rng.normal(size=(c, k))) \
        * np.sqrt(0.5)
    return (10 ** (snr_db / 20) * (a @ s) + n).astype(dtype)


def _ura_snapshots(truth, nx, ny, k, noise, seed, coherent=None):
    rng = np.random.default_rng(seed)
    a = tmusic.steering_ura(truth[:, 0], truth[:, 1], nx, ny, 0.5)
    m = len(truth)
    a = np.stack([a[:, i * m + i] for i in range(m)], axis=1)
    if coherent is None:
        s = (rng.normal(size=(m, k)) + 1j * rng.normal(size=(m, k))) \
            / np.sqrt(2)
    else:
        s0 = (rng.normal(size=k) + 1j * rng.normal(size=k)) / np.sqrt(2)
        s = np.stack([s0, coherent * s0])
    n = (rng.normal(size=(nx * ny, k)) + 1j * rng.normal(size=(nx * ny, k))
         ) * np.sqrt(0.5) * noise
    return a @ s + n


T = torch.from_numpy


def _proj(en) -> np.ndarray:
    en = np.asarray(en)
    return en @ en.conj().T


@pytest.mark.parametrize("c,truth,snr,m", [
    (10, [-20.0, 0.0, 15.0], 10.0, 3), (16, [-1.5, 2.0], 20.0, 2),
    (128, [-5.0, -4.0, 10.0], 5.0, 3)])
def test_music_1d_matches_jax(c, truth, snr, m):
    d = WL / 2 if c != 16 else D16
    x = _ula_snapshots(truth, c, d, 512 if c != 16 else 256, snr, seed=c)
    scan = np.arange(-30.0, 30.0 + 1e-9, 0.05)
    r_t = tmusic.covariance(T(x))
    r_j = jmusic.covariance(jnp.asarray(x))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(_proj(tmusic.noise_subspace(r_t, m)),
                               _proj(jmusic.noise_subspace(r_j, m)),
                               atol=1e-9)
    got = tmusic.music_1d(T(x), m, d, WL, scan)
    want = jmusic.music_1d(jnp.asarray(x), m, d, WL, scan)
    np.testing.assert_allclose(got.spectrum.numpy(),
                               np.asarray(want.spectrum), rtol=1e-5)
    np.testing.assert_array_equal(got.peaks_deg, want.peaks_deg)
    np.testing.assert_allclose(got.peaks_deg, truth, atol=0.3)
    np.testing.assert_allclose(
        tmusic.conventional_beam_spectrum(T(x), scan, d, WL).numpy(),
        np.asarray(jmusic.conventional_beam_spectrum(jnp.asarray(x), scan,
                                                     d, WL)), rtol=1e-9)


@pytest.mark.parametrize("impl", ["device", "host"])
def test_music_2d_matches_jax(impl):
    truth = np.array([[20.0, 30.0], [-30.0, 60.0]])
    x = _ura_snapshots(truth, 8, 8, 256, 0.1, seed=0)
    got = tmusic.music_2d(T(x), 2, 8, 8, 0.5, peak_impl=impl)
    want = jmusic.music_2d(jnp.asarray(x), 2, 8, 8, 0.5, peak_impl=impl)
    np.testing.assert_allclose(got.spectrum.numpy(),
                               np.asarray(want.spectrum), rtol=1e-5)
    np.testing.assert_array_equal(got.peaks_deg, want.peaks_deg)
    order = np.argsort(got.peaks_deg[:, 0])
    np.testing.assert_allclose(got.peaks_deg[order], truth[[1, 0]],
                               atol=1.5)


def test_music_2d_128_elements_zoom_matches_jax():
    """BASELINE config 4's 16x8 URA: the coarse 1-deg grid and the zoom
    refinement give JAX's peaks (complex64 snapshots, as the JAX test)."""
    truth = np.array([[12.3, 25.7], [-40.6, 55.4]])
    x = _ura_snapshots(truth, 16, 8, 512, 0.1, seed=4).astype(np.complex64)
    az = np.arange(-60.0, 60.0 + 1e-9, 1.0)
    el = np.arange(10.0, 80.0 + 1e-9, 1.0)
    for refine in (False, True):
        got = tmusic.music_2d(T(x), 2, 16, 8, 0.5, az_deg=az, el_deg=el,
                              refine=refine)
        want = jmusic.music_2d(jnp.asarray(x), 2, 16, 8, 0.5, az_deg=az,
                               el_deg=el, refine=refine)
        np.testing.assert_allclose(got.peaks_deg, want.peaks_deg,
                                   atol=1e-9, err_msg=str(refine))
        err = np.abs(got.peaks_deg[np.argsort(got.peaks_deg[:, 0])]
                     - truth[np.argsort(truth[:, 0])]).max()
        assert err < (0.15 if refine else 0.5 + 1e-6)
    with pytest.raises(ValueError, match="device picker only"):
        tmusic.music_2d(T(x), 2, 16, 8, 0.5, az_deg=az, el_deg=el,
                        refine=True, peak_impl="host")


def test_regional_max_picker_marks_missing_peaks():
    spec = torch.arange(12.0).reshape(3, 4) + 1.0    # monotone
    idx, vals = tmusic.regional_max_peaks_2d(spec, 3)
    assert torch.isfinite(vals).tolist() == [True, False, False]
    assert int(idx[0]) == 11


def test_regional_max_picks_tie_as_index_sets():
    """A plane with tied regional maxima: the picks equal JAX's top_k as a
    set of (index, value) pairs."""
    spec = np.zeros((9, 9))
    for i, j in [(1, 1), (1, 7), (7, 1), (7, 7)]:
        spec[i, j] = 5.0
    spec[4, 4] = 9.0
    idx, vals = tmusic.regional_max_peaks_2d(torch.from_numpy(spec), 5)
    jidx, jvals = jmusic.regional_max_peaks_2d(jnp.asarray(spec), 5)
    assert sorted(zip(idx.tolist(), vals.tolist())) == \
        sorted(zip(np.asarray(jidx).tolist(), np.asarray(jvals).tolist()))
    assert int(idx[0]) == 40


@pytest.mark.parametrize("case", ["three_10el", "close_16el", "coherent",
                                  "128el"])
def test_root_music_and_esprit_match_jax(case):
    smooth = None
    if case == "three_10el":
        truth, x, d, m = [-20.0, 0.0, 15.0], None, WL / 2, 3
        x = _ula_snapshots(truth, 10, d, 512, 10.0, seed=9)
    elif case == "close_16el":
        truth, d, m = [-1.53, 2.07], D16, 2
        x = _ula_snapshots(truth, 16, d, 256, 20.0, seed=7)
    elif case == "coherent":
        truth, d, m, smooth = [-3.0, 3.0], WL / 2, 2, 12
        rng = np.random.default_rng(0)
        s = (rng.standard_normal(256) + 1j * rng.standard_normal(256)) \
            / np.sqrt(2)
        a = steering_vector(np.asarray(truth), 16, d, WL)
        x = (np.outer(a[:, 0], s) + np.exp(0.9j * np.pi) * np.outer(a[:, 1], s)
             + (rng.standard_normal((16, 256))
                + 1j * rng.standard_normal((16, 256))) * np.sqrt(0.5) * 0.03)
    else:
        truth, d, m = [-5.0, -4.0, 10.0], WL / 2, 3
        x = _ula_snapshots(truth, 128, d, 512, 5.0, seed=2)
    for fn_t, fn_j, kw in ((tsr.root_music_1d, jsr.root_music_1d, {}),
                           (tsr.esprit_1d, jsr.esprit_1d, {"tls": True}),
                           (tsr.esprit_1d, jsr.esprit_1d, {"tls": False})):
        got = fn_t(T(x), m, d, WL, smooth=smooth, **kw)
        want = fn_j(jnp.asarray(x), m, d, WL, smooth=smooth, **kw)
        np.testing.assert_allclose(got, want, atol=1e-9,
                                   err_msg=f"{fn_t.__name__} {kw}")
        np.testing.assert_allclose(got, truth, atol=0.1)


def test_superres_complex64_promotes_to_host_f64():
    """complex64 snapshots (128 elements, a coherent pair, smoothing): the
    f64 host tail keeps every trial on the truth (as JAX's test)."""
    truth = np.array([-8.3, 4.6])
    a = steering_vector(truth, 128, D16, WL)
    rng = np.random.default_rng(1)
    for _ in range(3):
        s0 = rng.normal(size=512) + 1j * rng.normal(size=512)
        s = np.stack([s0, 0.7 * np.exp(1.3j) * s0])
        n = (rng.normal(size=(128, 512)) + 1j * rng.normal(size=(128, 512))
             ) * np.sqrt(0.5) * 0.3
        x = T((a @ s / np.sqrt(2) + n).astype(np.complex64))
        np.testing.assert_allclose(tsr.root_music_1d(x, 2, D16, WL,
                                                     smooth=64), truth,
                                   atol=0.1)
        np.testing.assert_allclose(tsr.esprit_1d(x, 2, D16, WL, smooth=64),
                                   truth, atol=0.1)


@pytest.mark.parametrize("case", ["offgrid", "swapped", "coherent"])
def test_esprit_2d_matches_jax(case):
    smooth = None
    if case == "offgrid":
        truth = np.array([[12.34, 25.71], [12.9, 55.43], [-40.62, 40.2]])
        x = _ura_snapshots(truth, 16, 8, 512, 0.1, seed=6)
    elif case == "swapped":
        truth = np.array([[31.0, 54.3], [59.0, 54.3]])
        x = _ura_snapshots(truth, 16, 8, 512, 0.1, seed=5)
    else:
        truth = np.array([[10.5, 30.2], [-25.4, 52.8]])
        x = _ura_snapshots(truth, 16, 8, 512, 0.05, seed=8,
                           coherent=0.8 * np.exp(2.1j))
        smooth = (12, 6)
    m = len(truth)
    for tls in (True, False):
        got = tsr.esprit_2d(T(x), m, 16, 8, 0.5, tls=tls, smooth=smooth)
        want = jsr.esprit_2d(jnp.asarray(x), m, 16, 8, 0.5, tls=tls,
                             smooth=smooth)
        np.testing.assert_allclose(got, want, atol=1e-9, err_msg=str(tls))
        np.testing.assert_allclose(got, truth[np.argsort(truth[:, 0])],
                                   atol=0.3)


def test_spatial_smoothing_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 64)) + 1j * rng.normal(size=(32, 64))
    r_t, r_j = tmusic.covariance(T(x)), jmusic.covariance(jnp.asarray(x))
    for fb in (True, False):
        np.testing.assert_allclose(
            tsr.spatial_smooth(r_t, 20, fb).numpy(),
            np.asarray(jsr.spatial_smooth(r_j, 20, fb)), rtol=1e-12,
            atol=1e-12)
        np.testing.assert_allclose(
            tsr.spatial_smooth_2d(r_t, 8, 4, 5, 3, fb).numpy(),
            np.asarray(jsr.spatial_smooth_2d(r_j, 8, 4, 5, 3, fb)),
            rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="sub_len"):
        tsr.spatial_smooth(r_t, 1)
    with pytest.raises(ValueError, match="URA needs"):
        tsr.esprit_2d(T(x), 2, 8, 8)
    for fn in (tsr.root_music_1d, tsr.esprit_1d):
        with pytest.raises(ValueError):
            fn(T(x[:4]), 4, D16, WL)


def test_simulate_snapshots_model():
    """The snapshot model on the CPU from a seeded generator: the shape and
    dtype asked for, the noise power, the same draws from the same seed,
    and MUSIC on them finds the truths."""
    truth = [-20.0, 0.0, 15.0]
    x = tmusic.simulate_snapshots(0, truth, 10, WL / 2, WL, 4096,
                                  snr_db=10.0, dtype=torch.complex128,
                                  device="cpu")
    assert x.shape == (10, 4096) and x.dtype == torch.complex128
    again = tmusic.simulate_snapshots(
        torch.Generator().manual_seed(0), truth, 10, WL / 2, WL, 4096,
        snr_db=10.0, dtype=torch.complex128, device="cpu")
    assert torch.equal(x, again)
    power = float(x.abs().pow(2).mean())
    assert abs(power - (3 * 10.0 + 1.0)) < 1.5
    np.testing.assert_allclose(tmusic.music_1d(x, 3, WL / 2, WL).peaks_deg,
                               truth, atol=0.5)
    x32 = tmusic.simulate_snapshots(1, truth, 10, WL / 2, WL, 64,
                                    device="cpu")
    assert x32.dtype == torch.complex64


def test_monopulse_matches_jax():
    wl = full_config().sig.wavelength
    for corrected in (True, False):
        tb = tmono.make_sum_diff_beams(16, D16, wl, corrected=corrected)
        jb = jmono.make_sum_diff_beams(16, D16, wl, corrected=corrected)
        for f in ("coeffs_sum", "coeffs_diff", "k_monopulse",
                  "ratio_offset"):
            np.testing.assert_allclose(getattr(tb, f), getattr(jb, f),
                                       rtol=1e-12, err_msg=f)
        sig = steering_vector(np.array([2.0]), 16, D16, wl)[:, 0]
        est = tmono.estimate_angle(tb, sig)
        assert est == pytest.approx(jmono.estimate_angle(jb, sig),
                                    rel=1e-12)
        # the reference's uncorrected variant keeps its missing null
        assert abs(est - (2.0 if corrected else 0.12)) < \
            (0.3 if corrected else 0.01)
    for a, b in zip(tmono.sum_diff_patterns(tb, D16, wl),
                    jmono.sum_diff_patterns(jb, D16, wl)):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_calibration_matches_jax():
    w = assets.dbf_coeffs()
    np.testing.assert_array_equal(w, jassets.dbf_coeffs())
    _, resp, peaks = tcal.beam_patterns_reference(w)
    _, jresp, jpeaks = jcal.beam_patterns_reference(w)
    np.testing.assert_allclose(resp, jresp, rtol=1e-12)
    # the quirks reproduce the pasted LUT exactly
    np.testing.assert_allclose(peaks, assets.BEAM_ANGLES_DEG_16CH,
                               atol=1e-9)
    _, p_sys, pk_sys = tcal.beam_patterns(np.fliplr(w).conj(), 0.0138, WL)
    _, jp_sys, jpk_sys = jcal.beam_patterns(np.fliplr(w).conj(), 0.0138, WL)
    np.testing.assert_allclose(p_sys, jp_sys, rtol=1e-12)
    np.testing.assert_array_equal(pk_sys, jpk_sys)
    angles = np.asarray(assets.BEAM_ANGLES_DEG_16CH)
    for ratio in ("complex", "magnitude"):
        ks = tcal.calibrate_k_slopes(np.fliplr(w), angles, D16, WL,
                                     ratio=ratio, span_factor=1.0)
        jks = jcal.calibrate_k_slopes(np.fliplr(w), angles, D16, WL,
                                      ratio=ratio, span_factor=1.0)
        np.testing.assert_allclose(ks, jks, rtol=1e-12, err_msg=ratio)
    # the reference's procedure gives the pinned values, not the pasted
    # LUT (a documented reference inconsistency, tests/test_doa.py:214)
    kc = tcal.calibrate_k_slopes(np.fliplr(w), angles, D16, WL,
                                 ratio="complex", span_factor=1.0)
    np.testing.assert_allclose(kc[:4], [-2.5448, -2.3314, -2.2636, -2.3314],
                               atol=2e-3)
    assert np.max(np.abs(kc - assets.K_SLOPES_LUT_16CH)) > 1.0


@pytest.mark.parametrize("ranks", [2, 4])
def test_music_2d_snapshot_sharded_on_gloo_ranks(ranks):
    """``music_2d(mesh=)`` inside a rank program: the all-reduced
    covariance of the snapshot shards equals the one-process covariance,
    and every rank finds the one-process peaks (zoom-refined)."""
    truth = np.array([[12.0, 25.0], [-40.0, 55.0]])
    x = _ura_snapshots(truth, 16, 8, 512, 0.1, seed=11)
    az = np.arange(-60.0, 60.0 + 1e-9, 1.0)
    el = np.arange(10.0, 80.0 + 1e-9, 1.0)
    out = run_ranks(dryrun.music_2d_sharded, ranks, x, 2, 16, 8, az, el,
                    True, "cpu", device="cpu", timeout=240)
    want = tmusic.music_2d(T(x), 2, 16, 8, 0.5, az_deg=az, el_deg=el,
                           refine=True)
    r = tmusic.covariance(T(x)).numpy()
    for o in out:
        np.testing.assert_allclose(o["cov"], r, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(o["spectrum"], want.spectrum.numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(o["peaks"], want.peaks_deg, atol=1e-9)
