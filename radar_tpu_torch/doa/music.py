"""MUSIC super-resolution DoA — port of ``radar_tpu/doa/music.py``
(SURVEY.md section 2.2: MUSIC_1D.m, MUSIC_2D.m, run_music_algorithm.m).

The covariance is one X@X^H matmul (with ``mesh=``, snapshot-sharded inside
a rank program: ``parallel/collectives.covariance_snapshot_sharded``),
``torch.linalg.eigh`` splits the subspaces, and the spectrum scan is one
[C-M, C] x [C, grid] matmul in place of the reference's per-angle loop
(run_music_algorithm.m:60-70), scaling to 128 elements (BASELINE.json
config 4). Everything runs on the snapshots' device; the 1D peak picker and
the peak coordinates are host numpy.

Reference models covered:
  - 1D ULA (MUSIC_1D.m:20-48: 10-element lambda/2 array, eig -> noise
    subspace, spectrum 1/sum|Qn^H a|^2, peak picking)
  - radar geometry (run_music_algorithm.m:7-70: 16 channels, d=13.8 mm,
    fc=9.45 GHz, 256 snapshots, conventional-DBF comparison)
  - 2D URA (MUSIC_2D.m:32-93: steering exp(jk(x cos(el)cos(az) +
    y cos(el)sin(az))), grid spectrum, regional-max picking)

The eigenvectors of ``torch.linalg.eigh`` (cuSOLVER on the card) may differ
from LAPACK's in phase and, within degenerate groups, in basis; the
spectra and the noise-subspace projectors do not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .steering import steering_vector


class MusicResult(NamedTuple):
    scan_deg: np.ndarray        # [G] (1D) or tuple of axes (2D)
    spectrum: torch.Tensor      # [G] or [G_az, G_el]
    peaks_deg: np.ndarray       # [M] estimated DoAs — 1D path: ascending
    #                             angle; 2D pickers: descending power


def covariance(x: torch.Tensor) -> torch.Tensor:
    """Sample covariance X@X^H/K for X [C, K] (run_music_algorithm.m:45)."""
    return x @ x.mH / x.shape[1]


def noise_subspace(r: torch.Tensor, num_sources: int) -> torch.Tensor:
    """[C, C-M] noise-subspace basis from the covariance (ascending eigh:
    the first C-M columns span the noise subspace; the reference sorts
    descending and drops the first M, run_music_algorithm.m:48-57)."""
    _, vecs = torch.linalg.eigh(r)
    return vecs[:, : r.shape[0] - num_sources]


def _ula_steering(c: int, scan_deg, element_spacing: float,
                  wavelength: float, like: torch.Tensor) -> torch.Tensor:
    n = np.arange(c)[:, None]
    phase = (2.0 * np.pi * element_spacing / wavelength
             * np.sin(np.deg2rad(np.asarray(scan_deg)))[None, :])
    return torch.as_tensor(np.exp(1j * n * phase), device=like.device).to(
        like.dtype)


def _null_spectrum(en: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """||En^H a||^2 per steering column."""
    return (en.mH @ a).abs().pow(2).sum(dim=0)


def _inverse(denom: torch.Tensor) -> torch.Tensor:
    return 1.0 / (denom + torch.finfo(denom.dtype).eps)


def music_spectrum_1d(r: torch.Tensor, num_sources: int, scan_deg,
                      element_spacing: float,
                      wavelength: float) -> torch.Tensor:
    """P(theta) = 1 / ||En^H a(theta)||^2 over the scan grid, one matmul."""
    en = noise_subspace(r, num_sources)
    a = _ula_steering(r.shape[0], scan_deg, element_spacing, wavelength, r)
    return _inverse(_null_spectrum(en, a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def find_peaks_1d(scan_deg, spectrum, num_sources: int) -> np.ndarray:
    """Top-M strict local maxima by height (MUSIC_1D.m findpeaks idiom), in
    ascending angle order. Like MATLAB findpeaks it may return fewer than
    ``num_sources`` angles when the spectrum has fewer local maxima (two
    sources merged into one lobe); doa/superres.py resolves such pairs."""
    s = _np(spectrum)
    interior = (s[1:-1] > s[:-2]) & (s[1:-1] > s[2:])
    idx = np.nonzero(interior)[0] + 1
    if len(idx) == 0:
        idx = np.array([int(np.argmax(s))])
    order = np.argsort(s[idx])[::-1][:num_sources]
    return np.sort(np.asarray(scan_deg)[idx[order]])


def music_1d(x: torch.Tensor, num_sources: int, element_spacing: float,
             wavelength: float, scan_deg: np.ndarray | None = None
             ) -> MusicResult:
    """Full 1D MUSIC from snapshots X [C, K]."""
    if scan_deg is None:
        scan_deg = np.arange(-90.0, 90.0 + 1e-9, 0.1)
    spec = music_spectrum_1d(covariance(x), num_sources, scan_deg,
                             element_spacing, wavelength)
    peaks = find_peaks_1d(scan_deg, spec, num_sources)
    return MusicResult(np.asarray(scan_deg), spec, peaks)


def conventional_beam_spectrum(x: torch.Tensor, scan_deg,
                               element_spacing: float,
                               wavelength: float) -> torch.Tensor:
    """Hamming-weighted conventional DBF power spectrum for comparison
    (run_music_algorithm.m:80-85)."""
    c = x.shape[0]
    r = covariance(x)
    a = _ula_steering(c, scan_deg, element_spacing, wavelength, r) * \
        torch.as_tensor(np.hamming(c), device=r.device).to(r.dtype)[:, None]
    return (a.conj() * (r @ a)).sum(dim=0).real


def steering_ura(az_deg, el_deg, nx: int, ny: int, spacing_wavelengths: float
                 ) -> np.ndarray:
    """2D URA steering vectors [nx*ny, G_az*G_el] on the MUSIC_2D.m model:
    phase = 2*pi*d/lambda * (x*cos(el)cos(az) + y*cos(el)sin(az))."""
    az = np.deg2rad(np.atleast_1d(az_deg))[None, :, None]
    el = np.deg2rad(np.atleast_1d(el_deg))[None, None, :]
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    pos = np.stack([gx.ravel(), gy.ravel()], axis=1)  # [C, 2]
    u = np.cos(el) * np.cos(az)   # [1, Gaz, Gel]
    v = np.cos(el) * np.sin(az)
    phase = (2.0 * np.pi * spacing_wavelengths
             * (pos[:, 0][:, None, None] * u + pos[:, 1][:, None, None] * v))
    return np.exp(1j * phase).reshape(pos.shape[0], -1)


def regional_max_peaks_2d(spec: torch.Tensor, num_sources: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """8-neighborhood regional maxima + top-M selection on the spectrum's
    device: eight shifted maxima over a -inf-padded plane, then one
    ``torch.topk`` over the masked flat spectrum (no host copy of the
    plane). Returns ``(flat_idx [M], values [M])`` in descending value;
    entries past the regional maxima hold -inf. MUSIC_2D.m:119-144's
    imregionalmax + sort semantics (>= every neighbor); the order among
    equal values may differ from JAX's ``top_k``."""
    h, w = spec.shape
    pad = torch.nn.functional.pad(spec[None, None], (1, 1, 1, 1),
                                  value=-float("inf"))[0, 0]
    neigh = torch.full_like(spec, -float("inf"))
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            neigh = torch.maximum(neigh, pad[1 + di:1 + di + h,
                                             1 + dj:1 + dj + w])
    masked = torch.where(spec >= neigh, spec,
                         torch.full_like(spec, -float("inf")))
    vals, idx = torch.topk(masked.reshape(-1), num_sources)
    return idx, vals


def refine_peaks_zoom(en: torch.Tensor, peaks_coarse: np.ndarray,
                      nx: int, ny: int, spacing_wavelengths: float,
                      daz: float, del_: float, factor: int = 20
                      ) -> np.ndarray:
    """Two-stage zoom refinement: around each coarse (az, el) peak,
    re-evaluate the MUSIC null spectrum on a dense +-1-cell local grid
    (step = cell/``factor``) with the same noise subspace and take its
    minimum: sub-grid accuracy to cell/factor. One small [C-M, C] x
    [C, (2f+1)^2] matmul per peak on the device."""
    out = []
    nloc = 2 * factor + 1
    for azc, elc in peaks_coarse:
        az_l = np.linspace(azc - daz, azc + daz, nloc)
        el_l = np.linspace(elc - del_, elc + del_, nloc)
        a_l = torch.as_tensor(steering_ura(az_l, el_l, nx, ny,
                                           spacing_wavelengths),
                              device=en.device).to(en.dtype)
        k = int(torch.argmin(_null_spectrum(en, a_l)))
        out.append((az_l[k // nloc], el_l[k % nloc]))
    return np.asarray(out)


def music_2d(x: torch.Tensor, num_sources: int, nx: int, ny: int,
             spacing_wavelengths: float = 0.5,
             az_deg: np.ndarray | None = None,
             el_deg: np.ndarray | None = None,
             peak_impl: str = "device", refine: bool = False,
             mesh=None, snapshot_axis: str = "cpi") -> MusicResult:
    """2D MUSIC over an (azimuth, elevation) grid; peaks by regional max
    (MUSIC_2D.m:119-144).

    ``mesh=`` (a ``parallel.mesh.Mesh``, inside a rank program of
    ``parallel.multihost.run_ranks``): ``x`` is this rank's block of the
    snapshots [C, K/n], and the covariance is the all-reduce of the local
    outer products over ``snapshot_axis``. ``peak_impl="device"`` (the
    default) ranks regional maxima on the device
    (:func:`regional_max_peaks_2d`), ``"host"`` with the numpy picker.
    ``refine=True`` (device picker only) adds the zoom refinement
    (:func:`refine_peaks_zoom`)."""
    if az_deg is None:
        az_deg = np.arange(-90.0, 90.0 + 1e-9, 1.0)
    if el_deg is None:
        el_deg = np.arange(0.0, 90.0 + 1e-9, 1.0)
    if mesh is not None:
        from ..parallel.collectives import covariance_snapshot_sharded
        from ..parallel.mesh import check_mesh

        r = covariance_snapshot_sharded(check_mesh(mesh), snapshot_axis)(x)
    else:
        r = covariance(x)
    en = noise_subspace(r, num_sources)
    a = torch.as_tensor(steering_ura(az_deg, el_deg, nx, ny,
                                     spacing_wavelengths),
                        device=r.device).to(r.dtype)
    spec = _inverse(_null_spectrum(en, a)).reshape(len(az_deg), len(el_deg))
    az0, el0 = np.asarray(az_deg), np.asarray(el_deg)

    if refine and peak_impl != "device":
        # refuse rather than return grid-quantized peaks for a caller who
        # asked for ~cell/20 accuracy
        raise ValueError("refine=True is implemented on the device "
                         "picker only (peak_impl='device')")
    if peak_impl == "device":
        idx, vals = regional_max_peaks_2d(spec, num_sources)
        # fewer regional maxima than num_sources: the masked top-k fills
        # the tail with -inf entries at arbitrary cells; drop them
        keep = torch.isfinite(vals)
        ii, jj = np.unravel_index(_np(idx[keep]), spec.shape)
        peaks = np.stack([az0[ii], el0[jj]], axis=1)
        if refine:
            daz = az0[1] - az0[0] if len(az0) > 1 else 1.0
            del_ = el0[1] - el0[0] if len(el0) > 1 else 1.0
            peaks = refine_peaks_zoom(en, peaks, nx, ny,
                                      spacing_wavelengths, daz, del_)
        return MusicResult((az0, el0), spec, peaks)
    if peak_impl != "host":
        raise ValueError(f"unknown peak_impl {peak_impl!r}")

    s = _np(spec)
    # 8-neighborhood regional maxima (host reference picker)
    pad = np.pad(s, 1, constant_values=-np.inf)
    is_max = np.ones_like(s, bool)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            is_max &= s >= pad[1 + di:1 + di + s.shape[0],
                               1 + dj:1 + dj + s.shape[1]]
    ii, jj = np.nonzero(is_max)
    order = np.argsort(s[ii, jj])[::-1][:num_sources]
    peaks = np.stack([az0[ii[order]], el0[jj[order]]], axis=1)
    return MusicResult((az0, el0), spec, peaks)


def simulate_snapshots(generator, angles_deg, num_elements: int,
                       element_spacing: float, wavelength: float,
                       num_snapshots: int, snr_db: float = 10.0,
                       dtype=torch.complex64, device="cuda") -> torch.Tensor:
    """Random-signal ULA snapshot model X = A S + N
    (run_music_algorithm.m:24-39) on ``device``. ``generator``: a
    ``torch.Generator`` on ``device`` (in place of JAX's key) or an int
    seed; the four draws (signal re/im, noise re/im) are taken in that
    order."""
    device = torch.device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device).manual_seed(int(generator))
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    a = torch.as_tensor(steering_vector(np.asarray(angles_deg), num_elements,
                                        element_spacing, wavelength),
                        device=device).to(dtype)
    m = len(np.atleast_1d(angles_deg))
    draw = lambda rows: torch.randn((rows, num_snapshots), dtype=real,
                                    device=device, generator=generator)
    half = torch.sqrt(torch.tensor(0.5, dtype=real, device=device))
    s = torch.complex(draw(m), draw(m)) * half
    n = torch.complex(draw(num_elements), draw(num_elements)) * half
    return 10.0 ** (snr_db / 20.0) * (a @ s) + n
