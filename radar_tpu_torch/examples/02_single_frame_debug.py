"""Tutorial: stage-by-stage single-frame debug harness — port of
``examples/02_single_frame_debug.py``.

The framework-native counterpart of the reference's debug checklist
(debug_simulated_data_processing.m:7-14): Fig 1 DBF energy band -> Fig 2 RDM
bright spot -> Fig 3 CFAR detections, with truth markers.

Run: python -m radar_tpu_torch.examples.02_single_frame_debug [--cpu]
         [--figures]

Writes the stage taps' shapes, the counts and the final targets to
``out_debug/stage_taps.json`` under the working directory; ``--figures``
also draws ``out_debug/pc_profile.png`` and ``rdm.png`` (needs
matplotlib, checked before the frame runs; JAX's tutorial always draws
them).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config.params import small_test_config
from ..pipeline.frame import make_frame_processor
from ..scripts._common import pick_device, require_matplotlib, write_json
from ..sim.scenario import TargetBatch
from ..waveform.precompute import precompute


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    ap.add_argument("--figures", action="store_true",
                    help="draw the PC profile and the RDM (matplotlib)")
    args = ap.parse_args(argv)
    if args.figures:
        require_matplotlib("--figures")
    dev = pick_device(args.cpu)
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)
    process = make_frame_processor(cfg, pre, device=dev,
                                   return_intermediates=True)
    truth_r, truth_v = 3000.0, 10.0
    tb = TargetBatch.make([truth_r], [truth_v], [10.0], [20.0])
    inter = process(0, tb)

    os.makedirs("out_debug", exist_ok=True)
    res = inter.result
    print("raw IQ cube:", tuple(inter.raw_iq.shape))
    print("beams:", tuple(inter.beams.shape), "| PC:", tuple(inter.pc.shape),
          "| RDM:", tuple(inter.rdm.shape))
    print("raw detections:", int(res.num_raw_detections),
          "| final targets:", int(res.num_final))
    valid = res.targets.valid.cpu().numpy()
    final = {"range_m": res.targets.range_m.cpu().numpy()[valid].tolist(),
             "velocity_ms":
                 res.targets.velocity_ms.cpu().numpy()[valid].tolist()}
    print("final:", final["range_m"], final["velocity_ms"])
    taps = {name: list(getattr(inter, name).shape)
            for name in ("raw_iq", "beams", "pc", "rdm", "pair_maps")}
    out = {"taps": taps, "num_raw": int(res.num_raw_detections),
           "num_final": int(res.num_final), "final": final,
           "truth": {"range_m": truth_r, "velocity_ms": truth_v}}
    write_json(os.path.join("out_debug", "stage_taps.json"), out)
    if args.figures:
        from ..viz.plots import plot_pc_profile, plot_rdm

        rdm = inter.rdm.abs().cpu().numpy()
        best_beam = int(np.argmax(rdm.max(axis=(0, 1))))
        print("figures:",
              plot_pc_profile(inter.pc[0, :, best_beam].cpu().numpy(),
                              pre.range_axis, "out_debug/pc_profile.png",
                              truth_ranges=[truth_r]),
              plot_rdm(inter.rdm[:, :, best_beam].cpu().numpy(),
                       pre.range_axis, pre.velocity_axis,
                       "out_debug/rdm.png", truth_ranges=[truth_r]))
    return out


if __name__ == "__main__":
    main()
