"""Tutorial: LFM pulse compression basics and gate splicing — port of
``examples/01_pulse_compression_basics.py``.

The framework-native counterpart of the reference's pedagogy scripts
``test.m`` (3-pulse waveform, conv matched filtering, gate-splice demo with
boundary annotations, test.m:101-150) and ``simulation_learn.m`` (LFM
basics, FFT-domain pulse compression, simulation_learn.m:112-131).

Run: python -m radar_tpu_torch.examples.01_pulse_compression_basics [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config.params import full_config
from ..ops.pulse_compression import pulse_compress
from ..scripts._common import pick_device
from ..waveform.precompute import build_tx_pulse, precompute


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    dev = pick_device(ap.parse_args(argv).cpu)
    cfg = full_config()
    pre = precompute(cfg)
    tx, (n1, n2, n3, p2, p3) = build_tx_pulse(cfg)
    print(f"PRT: {cfg.sig.point_prt} samples @ {cfg.sig.fs/1e6:.0f} MHz")
    print(f"pulses: narrow {n1} / medium LFM {n2} / long LFM {n3} samples "
          f"at offsets 0 / 289 / 1284")
    print(f"spliced gates: {pre.gate_splits} -> {pre.n_total_gate} total")

    # single noiseless echo at gate 500 (medium segment)
    delay = 500
    echo = np.zeros(cfg.sig.point_prt, complex)
    echo[delay:] = tx[:cfg.sig.point_prt - delay]
    beams = torch.as_tensor(echo[None, :, None]).to(dev, torch.complex64)
    pc = pulse_compress(beams, pre).abs()[0, :, 0].cpu().numpy()
    peak = int(np.argmax(pc))
    print(f"\ninjected delay gate: {delay}; PC peak gate: {peak}")
    print(f"compression gain (peak/|input|): {pc[peak]:.1f}x "
          f"(theory ~ {n2} for the {n2}-sample medium chirp, reduced by the "
          f"kaiser(4.5) taper)")
    print("segment boundaries at gates 228 and 951 "
          "(each segment matched-filtered independently, then spliced)")
    return {"peak_gate": peak, "gain": float(pc[peak])}


if __name__ == "__main__":
    main()
