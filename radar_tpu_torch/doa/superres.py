"""Search-free super-resolution DoA: root-MUSIC and (TLS-)ESPRIT — port
of ``radar_tpu/doa/superres.py``.

Beyond the reference (which ships grid-search MUSIC only: MUSIC_1D.m,
run_music_algorithm.m): both methods share MUSIC's covariance -> subspace
split but replace the angle-grid scan with closed-form extraction, which
removes the grid-resolution floor.

Device/host split, the reference package's design and not a fallback: the
[C, K] covariance (and the spatial smoothing) runs on the snapshots'
device; the [C, C] eigendecomposition and the closed-form tails
(polynomial rooting, [M, M] non-Hermitian eigs) run on the host in
float64 (:func:`_host_eigvecs_f64`). The tails are numerically fragile in
float32 (a complex64 subspace flips ~2/3 of 128-element coherent-pair
trials) and cost microseconds at [C, C] scale.

Model: ULA with ``element_spacing`` metres at ``wavelength`` metres,
steering a(theta)_n = exp(j * n * 2*pi*d/lambda * sin(theta)) — the
run_music_algorithm.m:24-39 signal model.
"""

from __future__ import annotations

import numpy as np
import torch

from .music import covariance


def _host_eigvecs_f64(r) -> np.ndarray:
    """Ascending eigenvectors of the [C, C] covariance, computed on the
    host in float64 whatever the device dtype: the covariance is promoted
    to complex128 and symmetrized exactly before ``numpy.linalg.eigh``,
    which keeps the fragile closed-form tails stable (0/20 coherent-pair
    failures at 128 elements where a complex64 subspace fails ~2/3)."""
    r64 = (r.detach().cpu().numpy() if isinstance(r, torch.Tensor)
           else np.asarray(r)).astype(np.complex128)
    r64 = 0.5 * (r64 + r64.conj().T)      # exact Hermitian symmetrization
    _, vecs = np.linalg.eigh(r64)
    return vecs


def _phase_to_deg(phase: np.ndarray, element_spacing: float,
                  wavelength: float) -> np.ndarray:
    """Invert phi = 2*pi*d/lambda * sin(theta), clipping to the visible
    region (|sin| <= 1) so near-endfire noise cannot produce NaN."""
    s = phase * wavelength / (2.0 * np.pi * element_spacing)
    return np.rad2deg(np.arcsin(np.clip(s, -1.0, 1.0)))


def _forward_backward(r: torch.Tensor) -> torch.Tensor:
    """0.5 * (R + J R* J), J the exchange matrix: J R* J is R* reversed
    along both axes."""
    return 0.5 * (r + r.conj().flip(0, 1))


def spatial_smooth(r: torch.Tensor, sub_len: int,
                   forward_backward: bool = True) -> torch.Tensor:
    """Forward(-backward) spatially smoothed covariance [L, L] from a full
    [C, C] covariance: the mean of all C-L+1 overlapping subarray blocks
    R[p:p+L, p:p+L], optionally after forward-backward averaging.

    COHERENT sources (multipath: one waveform arriving from several
    angles) collapse the signal subspace to rank < M and break any
    subspace DoA method on the raw covariance; smoothing restores rank up
    to the number of averaged subarrays at the cost of aperture C -> L."""
    c = int(r.shape[0])
    if not 1 < sub_len <= c:
        raise ValueError(f"need 1 < sub_len <= {c}, got {sub_len}")
    if forward_backward:
        r = _forward_backward(r)
    blocks = [r[p:p + sub_len, p:p + sub_len] for p in range(c - sub_len + 1)]
    return torch.stack(blocks).mean(dim=0)


def root_music_1d(x: torch.Tensor, num_sources: int, element_spacing: float,
                  wavelength: float, smooth: int | None = None) -> np.ndarray:
    """Root-MUSIC DoAs (deg, sorted) from snapshots X [C, K].

    The MUSIC null spectrum a(z)^H En En^H a(z) along z = exp(j*phi) is a
    Laurent polynomial whose coefficients are the diagonal sums of
    Q = En En^H; its roots come in conjugate-reciprocal pairs, and the M
    roots strictly inside (and nearest to) the unit circle give the
    source phases — no angle grid, no scan-step quantization.

    ``smooth``: subarray length for :func:`spatial_smooth` — required for
    COHERENT sources (multipath), which rank-collapse the raw covariance.
    """
    r = covariance(x)
    if smooth is not None:
        r = spatial_smooth(r, smooth)
    c = int(r.shape[0])
    m = int(num_sources)
    if not 0 < m < c:
        raise ValueError(f"need 0 < num_sources < channels, got {m}/{c}")
    en = _host_eigvecs_f64(r)[:, : c - m]            # f64 host subspace
    q = en @ en.conj().T                             # [C, C] host tail
    # coeffs[k] = sum of the k-th diagonal of Q, k = -(C-1)..(C-1)
    coeffs = np.array([np.trace(q, offset=k) for k in range(c - 1, -c, -1)])
    roots = np.roots(coeffs)                         # 2C-2 roots
    # roots come in conjugate-reciprocal pairs; pick the M nearest the
    # unit circle by |1-|z|| over ALL roots (not just the strictly-inside
    # ones: with a degenerate/noiseless covariance a signal root can land
    # numerically ON or just outside the circle, and an inside-only filter
    # would silently return fewer than num_sources angles). Keep one root
    # per pair by preferring |z| <= 1 on ties.
    order = np.argsort(np.abs(1.0 - np.abs(roots))
                       + 1e-12 * (np.abs(roots) > 1.0))
    sig, used_phases = [], []
    for z in roots[order]:
        ph = np.angle(z)
        # skip the conjugate-reciprocal twin (same phase, mirrored radius)
        if any(abs(np.angle(np.exp(1j * (ph - p)))) < 1e-6
               for p in used_phases):
            continue
        sig.append(z)
        used_phases.append(ph)
        if len(sig) == m:
            break
    if len(sig) != m:
        # loud failure (the old inside-only filter silently returned a
        # short array); ValueError matches the module's validation errors
        # and survives python -O, unlike an assert
        raise ValueError(
            f"root-MUSIC found only {len(sig)} distinct roots for {m} "
            "sources (degenerate covariance?)")
    return np.sort(_phase_to_deg(np.angle(np.array(sig)), element_spacing,
                                 wavelength))


def spatial_smooth_2d(r: torch.Tensor, nx: int, ny: int, lx: int, ly: int,
                      forward_backward: bool = True) -> torch.Tensor:
    """2D forward(-backward) spatial smoothing for a URA covariance: the
    mean of all (nx-lx+1)*(ny-ly+1) overlapping lx-x-ly subarray blocks of
    the full [nx*ny, nx*ny] covariance (x-major element order of
    :func:`..music.steering_ura`), optionally after forward-backward
    averaging. The smoothed [lx*ly, lx*ly] output behaves as an lx-x-ly
    URA covariance for COHERENT 2D sources."""
    c = nx * ny
    if r.shape[0] != c:
        raise ValueError(f"covariance is {r.shape[0]}, URA needs {c}")
    if not (1 < lx <= nx and 1 < ly <= ny):
        raise ValueError(f"bad subarray {lx}x{ly} for {nx}x{ny}")
    if forward_backward:
        r = _forward_backward(r)
    # flat indices of the (px, py)-offset lx*ly subarray, x-major
    base = (np.arange(lx)[:, None] * ny + np.arange(ly)[None, :]).ravel()
    blocks = []
    for px in range(nx - lx + 1):
        for py in range(ny - ly + 1):
            sel = torch.as_tensor(base + px * ny + py, device=r.device)
            blocks.append(r[sel[:, None], sel[None, :]])
    return torch.stack(blocks).mean(dim=0)


def _rotation_operator(e1: np.ndarray, e2: np.ndarray, m: int,
                       tls: bool) -> np.ndarray:
    """Psi solving E1 @ Psi ~= E2 — LS or total-least-squares (eigh of the
    stacked [2M, 2M] Gram; noise lives in BOTH subarray copies)."""
    if tls:
        stacked = np.concatenate([e1, e2], axis=1)   # [rows, 2M]
        g = np.conj(stacked.T) @ stacked
        _, v = np.linalg.eigh(g)
        vn = v[:, :m]                                # smallest M eigenpairs
        v12, v22 = vn[:m], vn[m:]
        return -v12 @ np.linalg.inv(v22)
    psi, *_ = np.linalg.lstsq(e1, e2, rcond=None)
    return psi


def _joint_eigvecs(psi_x: np.ndarray, psi_y: np.ndarray,
                   tol: float = 1e-3) -> np.ndarray:
    """Eigenvector matrix T that SIMULTANEOUSLY diagonalizes Psi_x and
    Psi_y, found by diagonalizing a complex combination a*Psi_x + b*Psi_y
    and verifying the off-diagonal residual of both rotated operators.

    The eigenvalues of a*Psi_x + b*Psi_y are a*e^{jku_m} + b*e^{jkv_m};
    for REAL a=b=1 they coincide whenever two sources have swapped or
    mirrored (u, v) projections (e^{jku1}+e^{jkv1} = e^{jku2}+e^{jkv2}
    with {u1,v1} = {u2,v2} as sets), and eig() of the defective-looking
    sum then returns vectors that diagonalize NEITHER operator — both
    (az, el) estimates come out ~10 deg wrong with no error raised. A
    complex-rotated combination breaks that symmetry; distinct fallback
    rotations cover the (measure-zero) collisions of any single choice.
    Raises ValueError if every combination stays degenerate."""
    combos = [(1.0, 1j), (1.0, np.exp(0.4j)), (np.exp(0.9j), 1.0),
              (1.0, 1.0)]
    best_t, best_res = None, np.inf
    for a, b in combos:
        _, t = np.linalg.eig(a * psi_x + b * psi_y)
        try:
            tinv = np.linalg.inv(t)
        except np.linalg.LinAlgError:
            continue
        res = 0.0
        for psi in (psi_x, psi_y):
            d = tinv @ psi @ t
            off = d - np.diag(np.diag(d))
            res = max(res, np.linalg.norm(off) / max(np.linalg.norm(d),
                                                     1e-30))
        if res < best_res:
            best_t, best_res = t, res
        if res < tol:
            return t
    if best_t is None or best_res > 0.2:
        raise ValueError(
            f"esprit_2d: no combination jointly diagonalizes Psi_x/Psi_y "
            f"(best off-diagonal residual {best_res:.3g}) — degenerate "
            "source geometry or wrong num_sources")
    return best_t


def esprit_2d(x: torch.Tensor, num_sources: int, nx: int, ny: int,
              spacing_wavelengths: float = 0.5, tls: bool = True,
              smooth: tuple | None = None) -> np.ndarray:
    """2D (TLS-)ESPRIT on a URA: search-free, AUTOMATICALLY PAIRED
    (az, el) estimates — the closed-form counterpart of the grid
    ``music_2d`` scan (MUSIC_2D.m steering model: element (x, y) phase
    2*pi*d*(x*u + y*v), u = cos(el)cos(az), v = cos(el)sin(az));
    beyond-reference, no 2D counterpart exists in the reference.

    Two maximal-overlap invariances (x-shift: element i vs i+ny; y-shift:
    i vs i+1 in the x-major layout of :func:`..music.steering_ura`) give
    rotation operators Psi_x, Psi_y sharing eigenvectors. Pairing is
    automatic: T diagonalizes a COMPLEX combination a*Psi_x + b*Psi_y
    (the real sum e^{jku}+e^{jkv} is degenerate whenever two sources have
    swapped/mirrored (u, v) projections — e.g. az 31/59 deg at el 54.3 —
    so a lone Psi_x+Psi_y silently mispairs there); the off-diagonal
    residual of BOTH T^-1 Psi_{x,y} T is checked and further fixed
    combinations are tried on degeneracy, then u_m, v_m read off the
    diagonals — no az/el association search. The covariance runs on the
    snapshots' device, the eigh and the [M, M] tail on the host in f64.
    Returns [M, 2] (az_deg, el_deg) sorted by azimuth.

    ``smooth=(lx, ly)``: 2D forward-backward spatial smoothing
    (:func:`spatial_smooth_2d`) for COHERENT sources — the invariances
    then live on the reduced lx-x-ly aperture."""
    r = covariance(x)
    c = nx * ny
    if r.shape[0] != c:
        raise ValueError(f"snapshots have {r.shape[0]} rows, URA needs {c}")
    if smooth is not None:
        lx, ly = smooth
        r = spatial_smooth_2d(r, nx, ny, lx, ly)
        nx, ny, c = lx, ly, lx * ly
    m = int(num_sources)
    if not 0 < m < min(c, (nx - 1) * ny, nx * (ny - 1)):
        raise ValueError(f"bad num_sources {m} for {nx}x{ny} URA")
    es = _host_eigvecs_f64(r)[:, c - m:]             # [C, M] signal space
    idx = np.arange(c)
    sx = idx[idx // ny < nx - 1]                     # x-shift pairs
    sy = idx[idx % ny < ny - 1]                      # y-shift pairs
    psi_x = _rotation_operator(es[sx], es[sx + ny], m, tls)
    psi_y = _rotation_operator(es[sy], es[sy + 1], m, tls)
    t = _joint_eigvecs(psi_x, psi_y)                 # shared eigenvectors
    tinv = np.linalg.inv(t)
    k = 2.0 * np.pi * spacing_wavelengths
    u = np.angle(np.diag(tinv @ psi_x @ t)) / k
    v = np.angle(np.diag(tinv @ psi_y @ t)) / k
    az = np.rad2deg(np.arctan2(v, u))
    el = np.rad2deg(np.arccos(np.clip(np.hypot(u, v), 0.0, 1.0)))
    out = np.stack([az, el], axis=1)
    return out[np.argsort(out[:, 0])]


def esprit_1d(x: torch.Tensor, num_sources: int, element_spacing: float,
              wavelength: float, tls: bool = True,
              smooth: int | None = None) -> np.ndarray:
    """(TLS-)ESPRIT DoAs (deg, sorted) from snapshots X [C, K].

    Signal subspace Es [C, M] from the covariance; the two maximally
    overlapping subarrays (rows 0..C-2 and 1..C-1) satisfy
    Es[1:] ~= Es[:-1] @ Psi with eig(Psi) = exp(j*phi_m). ``tls=True``
    solves the total-least-squares form (eigh of the stacked [2M, 2M]
    Gram matrix — noise lives in BOTH subarray copies), ``tls=False``
    the plain least squares. The final eig is non-Hermitian [M, M] and
    runs on the host in f64.

    ``smooth``: subarray length for :func:`spatial_smooth` (coherent
    sources; the rotational invariance then lives on the smoothed
    L-element array).
    """
    r = covariance(x)
    if smooth is not None:
        r = spatial_smooth(r, smooth)
    c = int(r.shape[0])
    m = int(num_sources)
    if not 0 < m < c:
        raise ValueError(f"need 0 < num_sources < channels, got {m}/{c}")
    es = _host_eigvecs_f64(r)[:, c - m:]             # [C, M] signal space
    psi = _rotation_operator(es[:-1], es[1:], m, tls)
    phases = np.angle(np.linalg.eigvals(psi))
    return np.sort(_phase_to_deg(phases, element_spacing, wavelength))
