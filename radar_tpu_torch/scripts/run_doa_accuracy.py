"""Monte-Carlo accuracy of every 128-element DoA method — the statistical
half of BASELINE config 4 ("MUSIC 1D/2D ... scaled to 128 elements") —
port of ``scripts/run_doa_accuracy.py``.

    python -m radar_tpu_torch.scripts.run_doa_accuracy [--trials 50]
        [--snapshots 512] [--out PATH] [--cpu]

Off-grid truths, fresh noise per trial; per-method RMSE (deg) and the mean
host-clock ms a call (each call ends on the host):

  1D (128-el ULA): grid MUSIC (0.1-deg scan), root-MUSIC, TLS-ESPRIT,
     and the COHERENT pair through forward-backward smoothing.
  2D (16x8 URA): grid MUSIC (1-deg), + two-stage zoom refinement,
     2D TLS-ESPRIT (auto-paired), and a coherent pair through 2D
     smoothing.

The snapshots and covariances are complex128 on the card (``--cpu`` for a
smoke run on the host); the subspace tails of root-MUSIC and ESPRIT run on
the host in float64 by design (``doa/superres.py``). Writes
``results/doa_accuracy_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config.params import full_config
from ..doa.music import music_1d, music_2d, simulate_snapshots, steering_ura
from ..doa.steering import steering_vector
from ..doa.superres import esprit_1d, esprit_2d, root_music_1d
from .run_roc_realdata import REPO, pick_device
from .run_tracking_mc import device_record


class _Timed:
    """Per-method errors and host-clock ms (synchronised at both ends)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.errs: dict = {}
        self.ms: dict = {}

    def __call__(self, name: str, fn, want) -> None:
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        got = fn()
        sync()
        self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        self.errs.setdefault(name, []).append(np.ravel(got - want))

    def rmse(self) -> dict:
        return {k: float(np.sqrt(np.mean(np.square(np.concatenate(v)))))
                for k, v in self.errs.items()}

    def mean_ms(self) -> dict:
        # the first call of a method includes its one-time set-up
        return {k: float(np.mean(v[1:] if len(v) > 1 else v))
                for k, v in self.ms.items()}


def run(args, device: torch.device) -> dict:
    cfg = full_config()
    d, wl = cfg.array.element_spacing, cfg.sig.wavelength
    trials, snap, snr_db = args.trials, args.snapshots, 5.0
    rng = np.random.default_rng(20260821)
    c128 = lambda a: torch.as_tensor(a, dtype=torch.complex128,
                                     device=device)
    t0 = time.perf_counter()

    # ---- 1D: 128-element ULA, 1-deg-separated off-grid pair -----------
    truth1 = np.array([-1.53, -0.47])      # sub-beamwidth separation
    scan = np.arange(-20.0, 20.0 + 1e-9, 0.1)
    one = _Timed(device)
    for _ in range(trials):
        x = simulate_snapshots(int(rng.integers(2**31)), truth1, 128, d, wl,
                               snap, snr_db=snr_db, dtype=torch.complex128,
                               device=device)
        one("music_grid", lambda: music_1d(x, 2, d, wl, scan).peaks_deg,
            truth1)
        one("root_music", lambda: root_music_1d(x, 2, d, wl), truth1)
        one("tls_esprit", lambda: esprit_1d(x, 2, d, wl), truth1)

    # coherent pair (multipath) through forward-backward smoothing
    truth1c = np.array([-8.3, 4.6])
    a1 = steering_vector(truth1c, 128, d, wl)
    for _ in range(trials):
        s0 = rng.normal(size=snap) + 1j * rng.normal(size=snap)
        s = np.stack([s0, 0.7 * np.exp(1j * 1.3) * s0])   # coherent copy
        n = (rng.normal(size=(128, snap))
             + 1j * rng.normal(size=(128, snap))) * np.sqrt(0.5) * 0.3
        x = c128(a1 @ s / np.sqrt(2) + n)
        one("root_music_coherent_smooth64",
            lambda: root_music_1d(x, 2, d, wl, smooth=64), np.sort(truth1c))

    # ---- 2D: 16x8 URA, off-grid (az, el) ------------------------------
    nx, ny = 16, 8

    def ura(truth):
        a = steering_ura(truth[:, 0], truth[:, 1], nx, ny, 0.5)
        return np.stack([a[:, i * len(truth) + i]
                         for i in range(len(truth))], axis=1)

    by_az = lambda p: p[np.argsort(p[:, 0])]
    truth2 = np.array([[12.34, 25.71], [-40.62, 55.43]])
    a2 = ura(truth2)
    az = np.arange(-60.0, 60.0 + 1e-9, 1.0)
    el = np.arange(10.0, 80.0 + 1e-9, 1.0)
    want2 = by_az(truth2)
    two = _Timed(device)
    for _ in range(trials):
        s = (rng.normal(size=(2, snap))
             + 1j * rng.normal(size=(2, snap))) / np.sqrt(2)
        n = (rng.normal(size=(nx * ny, snap))
             + 1j * rng.normal(size=(nx * ny, snap))) * np.sqrt(0.5) * 0.1
        x = c128(a2 @ s + n)
        two("music_grid_1deg", lambda: by_az(music_2d(
            x, 2, nx, ny, 0.5, az_deg=az, el_deg=el).peaks_deg), want2)
        two("music_zoom", lambda: by_az(music_2d(
            x, 2, nx, ny, 0.5, az_deg=az, el_deg=el,
            refine=True).peaks_deg), want2)
        two("esprit_2d", lambda: esprit_2d(x, 2, nx, ny, 0.5), want2)

    # coherent 2D pair through 2D smoothing
    truth2c = np.array([[10.5, 30.2], [-25.4, 52.8]])
    a2c = ura(truth2c)
    for _ in range(trials):
        s0 = rng.normal(size=snap) + 1j * rng.normal(size=snap)
        s = np.stack([s0, 0.8 * np.exp(1j * 2.1) * s0])
        n = (rng.normal(size=(nx * ny, snap))
             + 1j * rng.normal(size=(nx * ny, snap))) * np.sqrt(0.5) * 0.05
        x = c128(a2c @ s / np.sqrt(2) + n)
        two("esprit_2d_coherent_smooth12x6",
            lambda: esprit_2d(x, 2, nx, ny, 0.5, smooth=(12, 6)),
            by_az(truth2c))

    return {
        "trials": trials, "snapshots": snap, "snr_db": snr_db,
        "elements": 128, "dtype": "complex128",
        "1d_ula": {"truth_deg": truth1.tolist(),
                   "separation_deg": float(np.diff(truth1)[0]),
                   "rmse_deg": one.rmse(), "ms_per_call": one.mean_ms(),
                   "note": "grid RMSE floors at the 0.1-deg scan "
                           "quantization; the search-free methods go "
                           "below it"},
        "2d_ura_16x8": {"truth": truth2.tolist(), "rmse_deg": two.rmse(),
                        "ms_per_call": two.mean_ms(),
                        "note": "grid at 1 deg floors at ~0.3 (uniform "
                                "quantization); zoom and 2D ESPRIT are "
                                "sub-0.1"},
        "wall_s": time.perf_counter() - t0,
        "device": device_record(str(device)),
        "ms_is": "host clock around one call, synchronised at both ends, "
                 "mean over the trials after the first",
        "ref": "MUSIC_1D.m / MUSIC_2D.m / run_music_algorithm.m scaled "
               "per BASELINE.json config 4; search-free + coherent "
               "methods are beyond-reference",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (smoke runs)")
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--snapshots", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(
        REPO, "results", "doa_accuracy_torch.json"))
    args = ap.parse_args(argv)
    out = run(args, pick_device(args.cpu))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
