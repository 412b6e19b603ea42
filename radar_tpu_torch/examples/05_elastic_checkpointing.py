"""Tutorial: restart-on-failure and elastic recovery — port of
``examples/05_elastic_checkpointing.py``.

Two checkpointing subsystems cover the reference's staged-persistence
design (main_test_with_simulated_data.m:26-35,143-163) and its multi-rank
extension:

1. Host npz store (io/checkpoint.py): the frame loop persists each
   frame's measurement rows atomically; a rerun with the same store
   replays completed frames from disk and recomputes only the missing
   ones — field-exact, guarded by a run manifest that refuses a store
   written with a different (seed, config, scene).
2. The multi-rank store (io/orbax_store.py): each rank checkpoints only
   its own rows (no gather) and restores its block under a DIFFERENT
   mesh — here a dp=4 streaming Monte-Carlo run of 4 ranks stops after 2
   of its 4 scenes and 2 ranks resume it on dp=2, with final statistics
   bit-equal to the uninterrupted dp=4 run. The ranks are processes
   (``parallel.multihost.run_ranks``; on one card they share it).

Run: python -m radar_tpu_torch.examples.05_elastic_checkpointing [--cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np

from ..config.params import small_test_config
from ..io.checkpoint import CheckpointStore, SaveOptions
from ..io.orbax_store import OrbaxFrameStore
from ..parallel import dryrun
from ..parallel.multihost import run_ranks
from ..pipeline.driver import run_multiframe
from ..scripts._common import pick_device
from ..sim.scenario import TargetBatch
from ..waveform.precompute import precompute


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    dev = pick_device(ap.parse_args(argv).cpu)
    root = tempfile.mkdtemp(prefix="radar_ckpt_")
    try:
        return _run(root, dev)
    finally:
        shutil.rmtree(root)


def _run(root: str, dev) -> dict:
    cfg = small_test_config(channels=8, pulses=32)
    pre = precompute(cfg)

    print("== 1. restart-on-failure: the npz frame store ==")
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [18.0])
    store = CheckpointStore(os.path.join(root, "frames"),
                            SaveOptions(measurements=True))
    # a run that "dies" after 3 of 6 frames
    run_multiframe(cfg, tb, num_frames=3, seed=4, precomp=pre, store=store,
                   device=dev)
    print(f"   crashed run persisted frames "
          f"{store.frames_done('measurements')}")
    # the rerun replays 1-3 from disk, computes only 4-6
    log, tracks, _ = run_multiframe(cfg, tb, num_frames=6, seed=4,
                                    precomp=pre, store=store, progress=True,
                                    device=dev)
    print(f"   resumed -> {len(log)} rows, {len(tracks)} track(s); "
          f"frames done {store.frames_done('measurements')}")
    # the manifest refuses a mismatched resume (wrong seed here)
    try:
        run_multiframe(cfg, tb, num_frames=6, seed=5, precomp=pre,
                       store=store, device=dev)
        raise SystemExit("the mismatched seed was not refused")
    except ValueError as e:
        print(f"   mismatched seed refused: {str(e)[:72]}...")

    print("\n== 2. elastic recovery: the multi-rank store, dp=4 -> dp=2 ==")
    kw = dict(targets_per_scene=3, trials_per_scene=4, seed=5,
              snr_range=(12.0, 20.0))
    ck = os.path.join(root, "streaming")
    # 4 ranks: the dp=4 run "crashes" after 2 of 4 scenes (each rank saved
    # its trials of each scene as it completed), then the uninterrupted
    # dp=4 run for comparison
    first = run_ranks(dryrun.streaming_elastic, 4, cfg, ck, 2, kw,
                      dev.type, 4, 0, device=dev.type)
    print(f"   crashed dp=4 run persisted scenes "
          f"{OrbaxFrameStore(ck).frames_done()}")
    # 2 ranks: scenes 1-2 restore each rank's dp=2 block, 3-4 run fresh
    second = run_ranks(dryrun.streaming_elastic, 2, cfg, ck, 4, kw,
                       dev.type, 0, 0, device=dev.type)
    res, full = second[0]["run"], first[0]["uninterrupted"]
    for f in full._fields:
        np.testing.assert_array_equal(getattr(res, f), getattr(full, f),
                                      err_msg=f)             # NaN == NaN
    print(f"   elastic resume on dp=2: rate={res.detection_rate:.3f}, "
          f"detected {res.total_detected}/{res.total_targets} — bit-equal "
          "to the uninterrupted dp=4 run")
    print("\nok")
    return {"resumed": res, "uninterrupted": full,
            "log_rows": len(log), "tracks": len(tracks)}


if __name__ == "__main__":
    main()
