"""Tutorial: MUSIC super-resolution DoA vs conventional beamforming — port
of ``examples/03_music_doa.py``.

The framework-native counterpart of ``run_music_algorithm.m``: 16-channel
radar-geometry array, two sources 3.5 degrees apart — under the
conventional beamwidth — resolved by MUSIC; then the search-free
root-MUSIC and ESPRIT, and the 2D URA (MUSIC_2D.m scaled to 128
elements): grid MUSIC with device-side regional-max peaks and zoom
refinement against 2D TLS-ESPRIT. The snapshots of the 1D part come from a
seeded ``torch.Generator`` (JAX's from a key).

Run: python -m radar_tpu_torch.examples.03_music_doa [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config.params import full_config
from ..doa.music import (conventional_beam_spectrum, music_1d, music_2d,
                         simulate_snapshots, steering_ura)
from ..doa.superres import esprit_1d, esprit_2d, root_music_1d
from ..scripts._common import pick_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    dev = pick_device(ap.parse_args(argv).cpu)
    cfg = full_config()
    d, wl = cfg.array.element_spacing, cfg.sig.wavelength
    truth = [-1.5, 2.0]
    x = simulate_snapshots(0, truth, 16, d, wl, num_snapshots=256,
                           snr_db=20.0, device=dev)
    scan = np.arange(-20.0, 20.0, 0.1)
    res = music_1d(x, 2, d, wl, scan)
    print("truth:", truth, "-> MUSIC peaks:", np.round(res.peaks_deg, 2))
    conv = conventional_beam_spectrum(x, scan, d, wl).cpu().numpy()
    print("conventional DBF peak:", scan[int(np.argmax(conv))],
          "deg (single merged lobe — cannot separate the pair)")

    # search-free super-resolution: root-MUSIC roots the null-spectrum
    # polynomial, ESPRIT uses the shift invariance of two overlapping
    # subarrays — no scan grid, so no 0.1-deg quantization floor
    rm = root_music_1d(x, 2, d, wl)
    es = esprit_1d(x, 2, d, wl)
    print("root-MUSIC:", np.round(rm, 3))
    print("TLS-ESPRIT:", np.round(es, 3))

    # ---- 2D: the URA ------------------------------------------------
    nx, ny = 16, 8
    truth2 = np.array([[12.3, 25.7], [-40.6, 55.4]])      # off-grid (az, el)
    a2 = steering_ura(truth2[:, 0], truth2[:, 1], nx, ny, 0.5)
    cols = [a2[:, i * len(truth2) + i] for i in range(len(truth2))]
    rng = np.random.default_rng(0)
    s2 = (rng.normal(size=(2, 512)) + 1j * rng.normal(size=(2, 512)))
    n2 = (rng.normal(size=(nx * ny, 512))
          + 1j * rng.normal(size=(nx * ny, 512))) * np.sqrt(0.5) * 0.1
    x2 = torch.as_tensor(np.stack(cols, 1) @ s2 / np.sqrt(2) + n2).to(
        dev, torch.complex64)
    az = np.arange(-60.0, 60.0 + 1e-9, 1.0)
    el = np.arange(10.0, 80.0 + 1e-9, 1.0)
    coarse = music_2d(x2, 2, nx, ny, 0.5, az_deg=az, el_deg=el)
    fine = music_2d(x2, 2, nx, ny, 0.5, az_deg=az, el_deg=el, refine=True)
    es2 = esprit_2d(x2, 2, nx, ny, 0.5)
    print("\n2D truth (az, el):", truth2.tolist())
    print("grid MUSIC (1-deg grid):", np.asarray(coarse.peaks_deg).tolist())
    print("   + zoom refinement:   ",
          np.round(np.asarray(fine.peaks_deg), 2).tolist())
    print("2D TLS-ESPRIT (search-free, auto-paired):",
          np.round(es2, 2).tolist())
    return {"music_1d": np.asarray(res.peaks_deg), "root_music": rm,
            "esprit_1d": es, "music_2d": np.asarray(fine.peaks_deg),
            "esprit_2d": np.asarray(es2), "truth": truth, "truth2": truth2}


if __name__ == "__main__":
    main()
