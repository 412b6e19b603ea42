"""Tutorial: the real-data staged pipeline with per-stage checkpoints —
port of ``examples/04_realdata_stages.py``.

The framework-native counterpart of ``main_test_with_simulated_data.m``:
gated 3404-sample IQ -> stage 1 DBF (transposed coefficients) -> stage 2
PC+MTD with clutter suppression -> stage 3 segmented 1D CFAR -> stage 4
monopulse measurement with the per-frequency Angle-K table, persisting each
stage through the checkpoint store (the reference's save_options design)
into ``out_realdata/`` under the working directory.

Run: python -m radar_tpu_torch.examples.04_realdata_stages [--cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import assets
from ..config.params import RadarConfig, SigConfig
from ..io.checkpoint import CheckpointStore, SaveOptions
from ..ops.dbf import dbf
from ..pipeline.stages import (_segment_pulses, stage2_mtd,
                               stage3_detection, stage4_measurement)
from ..scripts._common import pick_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    dev = pick_device(ap.parse_args(argv).cpu)
    cfg = RadarConfig(sig=SigConfig(prt_num=64, channel_num=16,
                                    beam_num=13))
    sig = cfg.sig
    rng = np.random.default_rng(0)
    n_p, n_g, n_c = sig.prt_num, 3404, 16
    iq = (rng.normal(size=(n_p, n_g, n_c))
          + 1j * rng.normal(size=(n_p, n_g, n_c))) * np.sqrt(0.5)

    # one target in the long segment with the real-data conventions
    p1, p2, p3 = _segment_pulses(cfg)
    gate, vel = 1500, 12.0
    dphi = 2 * np.pi * 0.0138 * np.sin(np.deg2rad(12.0)) / sig.wavelength
    steer = np.exp(-1j * np.arange(n_c) * dphi)   # conj convention
    dop = np.exp(1j * 2 * np.pi * (2 * vel / sig.wavelength)
                 * np.arange(n_p) * sig.prt)
    seg = np.zeros(n_g, complex)
    seg[gate:gate + len(p3)] = p3
    iq += 8.0 * dop[:, None, None] * seg[None, :, None] * steer[None, None, :]

    store = CheckpointStore("out_realdata", SaveOptions(
        iq_after_dbf=True, mtd=True, cfar_flags=True, measurements=True))
    host = lambda t: t.cpu().numpy()
    beams = dbf(torch.as_tensor(iq).to(dev, torch.complex64),
                np.asarray(assets.dbf_coeffs()), "realdata")
    store.save("iq_after_dbf", 0, beams=host(beams))
    rdm, _ = stage2_mtd(beams, cfg)
    store.save("mtd", 0, rdm=host(rdm))
    dets, flags = stage3_detection(rdm, cfg)
    store.save("cfar_flags", 0, flags=host(flags))
    meas = stage4_measurement(dets, rdm, cfg, freq_no=6)
    valid = host(meas.valid)
    rows = {f: host(getattr(meas, f))[valid]
            for f in ("range_m", "velocity_ms", "elevation_deg", "power")}
    store.save("measurements", 0, range_m=rows["range_m"],
               velocity_ms=rows["velocity_ms"],
               elevation_deg=rows["elevation_deg"])

    i = int(np.argmax(rows["power"]))
    print(f"truth: gate {gate} (R={gate * 5.996:.0f} m), V={vel} m/s, "
          f"physical el 12 deg -> pair 4")
    print(f"best detection: R={rows['range_m'][i]:.1f} m, "
          f"V={rows['velocity_ms'][i]:.2f} m/s, "
          f"El(nominal frame)={rows['elevation_deg'][i]:.2f} deg")
    print("checkpoints:", sorted(os.listdir("out_realdata")))
    return {k: float(v[i]) for k, v in rows.items()}


if __name__ == "__main__":
    main()
