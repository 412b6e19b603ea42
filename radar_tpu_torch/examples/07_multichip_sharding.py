"""Tutorial: multi-device execution — meshes, shardings, collectives —
port of ``examples/07_multichip_sharding.py``.

The reference is strictly single-process (MATLAB; its only parallelism is
a shared-nothing ``parfor`` over Monte-Carlo trials,
main_plot_snr_vs_angle_error.m:167). The port scales along the physical
axes of the problem over ranks of ``torch.distributed`` (``Mesh``):

  dp   — data parallel: independent frames/trials
  ch   — array channels: synthesis + DBF partial sums all-reduced
  cpi  — slow time / range: all-to-all axis swaps between PC and MTD

This tutorial runs everything in ONE launch of 8 ranks
(``parallel.multihost.run_ranks``: processes on this host, on the card —
all 8 share it over gloo — or on the CPU with ``--cpu``). It shows,
smallest to largest:
  1. the communication patterns one at a time as explicit collectives
     (parallel/collectives.py) — all-reduce DBF, halo-exchange
     overlap-save PC, all-to-all MTD;
  2. the complete frame pipeline sharded over (dp=2, ch=2, cpi=2) with
     single-rank parity (parallel/sharded.py);
  3. a dp-sharded frame batch and the dp x (ch, cpi) composition — the
     cluster layout: dp across hosts, the model axes within one
     (parallel/dp.py).

Run: python -m radar_tpu_torch.examples.07_multichip_sharding [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config.params import CfarParams, ClusterParams, RadarConfig, SigConfig
from ..parallel.collectives import (dbf_channel_sharded, gather_along,
                                    mtd_cpi_sharded,
                                    pulse_compress_range_sharded,
                                    shard_along)
from ..parallel.dp import (broadcast_targets, make_dp_frame_processor,
                           make_dp_sharded_frame_processor)
from ..parallel.dryrun import host_result
from ..parallel.mesh import make_mesh
from ..parallel.multihost import run_ranks
from ..parallel.sharded import make_sharded_frame_processor
from ..pipeline.driver import frame_seed
from ..pipeline.frame import make_frame_processor
from ..scripts._common import pick_device
from ..sim.scenario import TargetBatch
from ..waveform.precompute import precompute

RANKS = 8


def tiny_config() -> RadarConfig:
    """8 channels, 16 pulses, the full fast-time geometry (JAX's
    tutorial's config)."""
    return RadarConfig(
        sig=SigConfig(prt_num=16, channel_num=8, beam_num=5),
        cfar=CfarParams(ref_cells_v=2, guard_cells_v=2, ref_cells_r=5,
                        guard_cells_r=10, max_detections=64),
        cluster=ClusterParams(max_clusters=32))


def rank_program(device: str) -> dict:
    """The body of each of the 8 ranks: every section of the tutorial,
    with the single-rank results it is held against."""
    cfg = tiny_config()
    pre = precompute(cfg)
    targets = TargetBatch.make([3000.0], [10.0], [5.0], [20.0])
    rng = np.random.default_rng(1)
    out = {}

    # 1a. channel-sharded DBF: each rank holds a block of channels, forms
    # its partial beam sum, and the beams are all-reduced over ch
    mesh_ch = make_mesh(ch=RANKS, device=device)
    iq = (rng.normal(size=(16, 128, 8))
          + 1j * rng.normal(size=(16, 128, 8))).astype(np.complex64)
    w = np.asarray(pre.dbf_w)[:5, :8].astype(np.complex64)
    beams = dbf_channel_sharded(mesh_ch, "ch")(
        shard_along(iq, mesh_ch, "ch", 2), shard_along(w, mesh_ch, "ch", 1))
    want = np.einsum("psc,bc->psb", iq, np.conj(w))
    out["dbf"] = (tuple(iq.shape), tuple(beams.shape),
                  float(np.abs(beams.cpu().numpy() - want).max()
                        / np.abs(want).max()))

    # 1b. range-sharded overlap-save PC: each shard convolves its block of
    # fast time, importing the trailing len(h)-1 samples of its left
    # neighbour over the ring
    mesh_r = make_mesh(cpi=RANKS, device=device)
    h = np.asarray(pre.tx_pulse, np.complex64)[:33]
    x = (rng.normal(size=(4, 512))
         + 1j * rng.normal(size=(4, 512))).astype(np.complex64)
    pc = pulse_compress_range_sharded(mesh_r, h, nfft=256, axis="cpi")
    y = gather_along(pc(shard_along(x, mesh_r, "cpi", 1)), mesh_r, "cpi", 1)
    pc.close()
    want = np.stack([np.convolve(x[i], h)[:512] for i in range(4)])
    out["pc"] = (len(h) - 1, float(np.abs(y.cpu().numpy() - want).max()
                                   / np.abs(want).max()))

    # 1c. cpi-sharded MTD: pulses are sharded, the slow-time FFT needs all
    # of them per gate — an all-to-all swaps pulses for gates, FFTs
    # locally, and swaps back
    cube = (rng.normal(size=(16, 256, 5))
            + 1j * rng.normal(size=(16, 256, 5))).astype(np.complex64)
    win = np.asarray(pre.mtd_win)[:16]
    rdm = gather_along(mtd_cpi_sharded(mesh_r, win)(
        shard_along(cube, mesh_r, "cpi", 0)), mesh_r, "cpi", 0)
    want = np.fft.fftshift(np.fft.fft(cube * win[:, None, None], axis=0),
                           axes=0)
    out["mtd"] = (tuple(cube.shape), tuple(rdm.shape),
                  float(np.abs(rdm.cpu().numpy() - want).max()
                        / np.abs(want).max()))

    # 2. the whole frame sharded over (dp=2, ch=2, cpi=2)
    mesh = make_mesh(2, 2, 2, device=device)
    out["sharded"] = host_result(make_sharded_frame_processor(
        cfg, mesh, pre)(0, targets))
    single = make_frame_processor(cfg, pre, device=mesh.device)
    out["single"] = host_result(single(0, targets))

    # 3a. pure dp: 8 independent frames, one a rank, each its own seed
    seeds = [frame_seed(0, i) for i in range(RANKS)]
    out["dp"] = host_result(make_dp_frame_processor(
        cfg, make_mesh(dp=RANKS, device=device), pre)(
        seeds, broadcast_targets(targets, RANKS)))
    # 3b. the cluster layout: the batch over dp, each frame over (ch, cpi)
    seeds4 = [frame_seed(0, 100 + i) for i in range(4)]
    out["dp_x_model"] = host_result(make_dp_sharded_frame_processor(
        cfg, mesh, pre)(seeds4, broadcast_targets(targets, 4)))
    out["dp_x_model_single"] = [host_result(single(s, targets))
                                for s in seeds4]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    dev = pick_device(ap.parse_args(argv).cpu)
    print(f"ranks: {RANKS} on {dev.type} (one launch)")
    res = run_ranks(rank_program, RANKS, dev.type, device=dev.type,
                    timeout=600)
    r0 = res[0]

    print("\n== 1. explicit collectives ==")
    shape_in, shape_out, err = r0["dbf"]
    print(f"dbf all-reduce over ch=8: iq{shape_in} -> beams{shape_out}, "
          f"max err {err:.1e} of max")
    halo, err = r0["pc"]
    print(f"overlap-save PC over range=8 shards: halo={halo} samples, "
          f"matches np.convolve ({err:.1e} of max)")
    shape_in, shape_out, err = r0["mtd"]
    print(f"mtd all-to-all over cpi=8: pc{shape_in} -> rdm{shape_out}, "
          f"max err {err:.1e} of max")
    if max(r0["dbf"][2], r0["pc"][1], r0["mtd"][2]) > 1e-4:
        raise SystemExit("a sharded collective differs from the unsharded "
                         "result")

    print("\n== 2. full frame pipeline sharded over (dp=2, ch=2, cpi=2) ==")
    sh, one = r0["sharded"], r0["single"]
    v = one["valid"].astype(bool)
    for r in res:
        if int(r["sharded"]["num_final"]) != int(one["num_final"]) or \
                not np.allclose(r["sharded"]["range_m"][v],
                                one["range_m"][v], rtol=1e-3):
            raise SystemExit("the sharded frame differs from one rank's")
    print(f"sharded == single-rank on every rank: {int(sh['num_final'])} "
          f"target(s), R={sh['range_m'][v].round(0).tolist()} m "
          f"(truth 3000 m)")

    print("\n== 3. dp batch + dp x (ch, cpi) composition ==")
    print(f"dp=8 frame batch: raw={r0['dp']['num_raw'].tolist()}")
    comp = r0["dp_x_model"]
    print(f"dp=2 x (ch=2, cpi=2): batch 4, raw={comp['num_raw'].tolist()}")
    for i, s in enumerate(r0["dp_x_model_single"]):
        if int(comp["num_final"][i]) != int(s["num_final"]):
            raise SystemExit("a dp x model frame differs from one rank's")
    print("\nAcross hosts the same code runs over a process group that spans "
          "them (python -m radar_tpu_torch.scripts.run_multiprocess starts "
          "coordinator-joined processes).")
    return r0


if __name__ == "__main__":
    main()
