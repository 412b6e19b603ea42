"""Multi-process runs of the multi-device layer on one host — port of
``scripts/run_multiprocess.py``: worker processes joined by
``torch.distributed`` through the standard environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), so ``parallel.multihost.initialize()``'s env
resolution runs, as JAX's script drives ``jax.distributed``'s.

    python -m radar_tpu_torch.scripts.run_multiprocess [--cpu] [--nproc 4]
    python -m radar_tpu_torch.scripts.run_multiprocess --bench [--perf]
        [--arms 1,2,4] [--trials-per-proc 16] [--bench-reps 3]
    python -m radar_tpu_torch.scripts.run_multiprocess --streaming [--perf]
        [--arms 1,2,4] [--scenes 16] [--targets-per-scene 8]
        [--trials-per-scene 4]

Modes (each worker at JAX's small config, 8 channels x 32 pulses):

- parity (default): every worker holds four runs against its own
  single-rank run of the same seeds: (1) the reference stream's frame
  sharded over dp x ch, (2) the rank-K stream's over dp x cpi, (3) a dp
  trial batch of which each rank makes only its own trials
  (``multihost.local_batch_slice``), gathered, and (4) the perf
  configuration's dp frame batch (``parallel/dp.py``; K1 and K2 on the
  card). Writes ``results/multiprocess_parity_torch.json``.
- ``--bench``: the weak-scaling arms: a fixed batch of trials a process,
  sharded over dp, at each process count of ``--arms``; trials/s. Writes
  ``results/multiprocess_scaling_torch.json``.
- ``--streaming``: the streaming Monte-Carlo with its scenes strided over
  the processes (scene s on process s mod N), the records gathered and
  aggregated as one process aggregates them; the arms of ``--arms`` must
  be bit-equal to each other. Writes
  ``results/streaming_mc_multiproc_torch.json``.

Workers run on the card (``--cpu``: gloo CPU ranks), one intra-op thread
each. On one card all ranks share it (gloo, the plain collectives staged
through the host): the arms' throughput then measures contention for that
card, not scaling, and the JSONs say so. With ``--cpu`` the JSONs go to
``build/``. The orchestrator gives every launch ``--timeout`` seconds and
kills exactly the processes it started when they outlive it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

from ._common import REPO, artifact_path, device_record, write_json

ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE")
STAT_KEYS = ("detection_rate", "total_detected", "snr_bin_rate",
             "snr_bin_counts", "range_rmse_m", "velocity_rmse_ms")
SHARED_CARD = ("the ranks share one card: the arms' throughput measures "
               "contention for it, not scaling")


# --------------------------------------------------------------------------
# workers
# --------------------------------------------------------------------------

def _join(args):
    """Join the process group from the environment (one process: none);
    (rank, world size, device type)."""
    import torch

    from ..parallel import multihost

    torch.set_num_threads(1)
    device = "cpu" if args.cpu else "cuda"
    if args.nproc > 1 and multihost.initialize(device=device) is not True:
        raise SystemExit("expected a multi-process group from the "
                         "environment")
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != args.nproc:
        raise SystemExit(f"world size {world} != --nproc {args.nproc}")
    return rank, world, device


def _log(rank, msg):
    print(f"[proc {rank}] {msg}", flush=True)


def _targets():
    from ..sim.scenario import TargetBatch

    return TargetBatch.make([3000.0, 9000.0], [10.0, 20.0], [10.0, 5.0],
                            [18.0, 15.0])


def worker_parity(args) -> dict:
    """The four parity checks against this process's single-rank runs;
    raises on the first that fails."""
    import numpy as np

    from ..config.params import perf_config, small_test_config
    from ..parallel import multihost
    from ..parallel.dp import broadcast_targets, make_dp_frame_processor
    from ..parallel.dryrun import host_result
    from ..parallel.sharded import make_sharded_frame_processor
    from ..pipeline.driver import frame_seed, trial_seed
    from ..pipeline.frame import make_frame_processor
    from ..pipeline.montecarlo import make_trial_fn
    from ..sim.scenario import TargetBatch
    from ..waveform.precompute import precompute

    rank, world, device = _join(args)
    if world % 2:
        raise SystemExit("parity takes an even --nproc (dp x 2 meshes)")
    cfg = small_test_config(channels=8, pulses=32)
    tb = _targets()
    report = {"nproc": world, "checks": []}

    def frame_parity(name, cfg_v, mesh):
        pre = precompute(cfg_v)
        ref = host_result(make_frame_processor(cfg_v, pre,
                                               device=mesh.device)(7, tb))
        out = host_result(make_sharded_frame_processor(cfg_v, mesh, pre)(
            7, tb))
        for k in ("num_raw", "num_final", "valid"):
            np.testing.assert_array_equal(out[k], ref[k], err_msg=name)
        v = ref["valid"].astype(bool)
        np.testing.assert_allclose(out["range_m"][v], ref["range_m"][v],
                                   rtol=1e-4, err_msg=name)
        for f in ("velocity_ms", "angle_deg"):
            np.testing.assert_allclose(out[f][v], ref[f][v], rtol=1e-3,
                                       atol=1e-3, err_msg=name)
        _log(rank, f"{name}: PARITY OK ({int(out['num_final'])} final "
             f"targets, {int(out['num_raw'])} raw detections)")
        report["checks"].append({"name": name, "ok": True,
                                 "mesh": dict(mesh.shape),
                                 "num_final": int(out["num_final"])})

    # 1) the reference stream: pulses over dp, channels over ch
    frame_parity("stream_dpxch", cfg, multihost.make_multihost_mesh(
        ch=2, device=device))
    # 2) the rank-K stream (xla chain): pulses and gates over dp x cpi
    frame_parity("lowrank_dpxcpi",
                 cfg.replace(fused_synth_dbf=True, lowrank_rdm=True),
                 multihost.make_multihost_mesh(cpi=2, device=device))

    # 3) dp trials: this rank makes only its slice of the batch
    pre = precompute(cfg)
    mesh = multihost.make_multihost_mesh(device=device)
    n = 2 * world
    seeds = [trial_seed(7, 0, t) for t in range(n)]
    sl = multihost.local_batch_slice(n, mesh)
    if sl != slice(2 * rank, 2 * rank + 2):
        raise SystemExit(f"local_batch_slice {sl} on rank {rank}")
    trial_fn = make_trial_fn(cfg, pre, device=mesh.device)
    one = TargetBatch(*(x[:1] for x in tb))
    angles, hits = trial_fn(one, seeds[sl])
    angles = mesh.all_gather(angles, "dp").cpu().numpy()
    hits = mesh.all_gather(hits, "dp").cpu().numpy()
    a_ref, h_ref = (x.cpu().numpy() for x in trial_fn(one, seeds))
    np.testing.assert_array_equal(hits, h_ref)
    np.testing.assert_array_equal(angles, a_ref)
    _log(rank, f"trials_dp: PARITY OK ({n} trials, local slice "
         f"{sl.start}:{sl.stop}, Pd={float(np.mean(hits)):.2f})")
    report["checks"].append({"name": "trials_dp", "ok": True,
                             "n_trials": n,
                             "local_slice": [sl.start, sl.stop]})

    # 4) the perf configuration's dp frame batch (K1 and K2 on the card)
    cfg_pf = perf_config(cfg)
    pre_pf = precompute(cfg_pf)
    fseeds = [frame_seed(21, i) for i in range(world)]
    batch = host_result(make_dp_frame_processor(cfg_pf, mesh, pre_pf)(
        fseeds, broadcast_targets(tb, world)))
    single = make_frame_processor(cfg_pf, pre_pf, device=mesh.device)
    for i, s in enumerate(fseeds):
        ref = host_result(single(s, tb))
        for k, v in ref.items():
            np.testing.assert_array_equal(batch[k][i], v,
                                          err_msg=f"perf_dp {i} {k}")
    _log(rank, f"perf_dp: PARITY OK ({world} perf frames across {world} "
         f"processes)")
    report["checks"].append({"name": "perf_dp", "ok": True,
                             "n_frames": world})
    _log(rank, "ALL PARITY CHECKS PASSED")
    return report


def _bench_cfg(args):
    from ..config.params import perf_config, small_test_config

    cfg = small_test_config(channels=8, pulses=32)
    return perf_config(cfg) if args.perf else cfg


def worker_bench(args) -> dict:
    """One weak-scaling arm: ``--trials-per-proc`` trials a process, dp
    over the processes, ``--bench-reps`` timed batches after two warm-up
    batches (host clock around batches that end on the host)."""
    import numpy as np

    from ..parallel import multihost
    from ..parallel.dp import make_dp_trial_fn
    from ..pipeline.driver import trial_seed
    from ..pipeline.montecarlo import make_trial_fn
    from ..sim.scenario import TargetBatch
    from ..waveform.precompute import precompute

    rank, world, device = _join(args)
    cfg = _bench_cfg(args)
    pre = precompute(cfg)
    tb = TargetBatch.make([3000.0], [10.0], [10.0], [18.0])
    n = args.trials_per_proc * world
    seeds = [trial_seed(11, 0, t) for t in range(n)]
    if world > 1:
        mesh = multihost.make_multihost_mesh(device=device)
        trial_fn = make_dp_trial_fn(cfg, mesh, pre)
    else:
        trial_fn = make_trial_fn(cfg, pre, device=device)
    run = lambda: float(np.nansum(trial_fn(tb, seeds)[0].cpu().numpy()))
    for _ in range(2):
        run()
    t0 = time.perf_counter()
    for _ in range(args.bench_reps):
        run()
    dt = (time.perf_counter() - t0) / args.bench_reps
    _log(rank, f"bench: {n} trials in {dt * 1e3:.1f} ms -> "
         f"{n / dt:.2f} trials/s")
    return {"nproc": world, "trials": n, "seconds_per_batch": dt,
            "trials_per_s": n / dt}


def worker_streaming(args) -> dict:
    """One streaming arm: every process draws every scene's truth (the
    scene rng's stream), runs the scenes s with s mod N == its rank, and
    the per-target records [scene, snr, detected, dR, dV] of every process
    are gathered, ordered by scene and aggregated."""
    import numpy as np

    from ..parallel import multihost
    from ..pipeline.driver import trial_seed
    from ..pipeline.frame import make_frame_processor
    from ..pipeline.streaming import _match_rate, aggregate_stats, \
        random_scene
    from ..waveform.precompute import precompute

    rank, world, device = _join(args)
    cfg = _bench_cfg(args)
    snr_range = (-5.0, 20.0)
    if args.scenes % world:
        raise SystemExit(f"--scenes {args.scenes} must divide evenly over "
                         f"{world} processes")
    rng = np.random.default_rng(args.seed)
    truths = [random_scene(rng, args.targets_per_scene, cfg, snr_range)
              for _ in range(args.scenes)]
    mine = [s for s in range(args.scenes) if s % world == rank]
    process = make_frame_processor(cfg, precompute(cfg), device=device)
    process(trial_seed(args.seed, mine[0], 0), truths[mine[0]])   # warm-up
    t0 = time.perf_counter()
    finals = {s: [process(trial_seed(args.seed, s, t), truths[s]).targets
                  for t in range(args.trials_per_scene)] for s in mine}
    rows = []
    for s in mine:
        for f in finals[s]:
            det, dr, dv = _match_rate(
                type(f)(*(None if x is None else x.cpu().numpy()
                          for x in f)), truths[s], 60.0, 3.0)
            rows.append(np.stack([np.full(len(det), s), truths[s].snr_db,
                                  det.astype(float), dr, dv], axis=1))
    wall = time.perf_counter() - t0
    local = np.concatenate(rows)
    walls = [wall]
    if world > 1:
        mesh = multihost.make_multihost_mesh(device=device)
        local = np.concatenate(mesh.all_gather_object(local, "dp"))
        walls = mesh.all_gather_object(wall, "dp")
    # one process aggregates scene by scene: the stable sort keeps each
    # scene's order
    allrec = local[np.argsort(local[:, 0], kind="stable")]
    stats = aggregate_stats(allrec[:, 1], allrec[:, 2].astype(bool),
                            allrec[:, 3], allrec[:, 4], snr_range)
    total = args.scenes * args.targets_per_scene * args.trials_per_scene
    _log(rank, f"{len(mine)} scenes in {wall:.2f}s; global rate "
         f"{stats.detection_rate:.4f}")
    return {"nproc": world, "scenes": args.scenes,
            "targets_per_scene": args.targets_per_scene,
            "trials_per_scene": args.trials_per_scene,
            "injected_targets": total, "perf_config": bool(args.perf),
            "seed": args.seed, "walls_per_worker_s": walls,
            "targets_per_s": total / max(walls),
            "detection_rate": stats.detection_rate,
            "total_detected": stats.total_detected,
            "snr_bin_rate": [float(x) for x in stats.snr_bin_rate],
            "snr_bin_counts": [int(x) for x in stats.snr_bin_counts],
            "range_rmse_m": stats.range_rmse_m,
            "velocity_rmse_ms": stats.velocity_rmse_ms}


def worker_main(args) -> int:
    import torch.distributed as dist

    fn = (worker_streaming if args.streaming else worker_bench if args.bench
          else worker_parity)
    try:
        report = fn(args)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(report, fh, indent=1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


# --------------------------------------------------------------------------
# orchestrator
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args, nproc: int, mode: list, tag: str):
    """Start ``nproc`` workers of ``mode`` joined through the environment,
    wait up to ``--timeout`` seconds, kill the ones still running (only the
    processes started here); (return codes, rank 0's report or None, the
    log paths)."""
    port = _free_port()
    os.makedirs(args.logdir, exist_ok=True)
    out = os.path.join(args.logdir, f"{tag}_{nproc}.json")
    if os.path.exists(out):
        os.remove(out)
    procs, logs, paths = [], [], []
    try:
        for rank in range(nproc):
            env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            env["OMP_NUM_THREADS"] = "1"
            if nproc > 1:
                env.update(RANK=str(rank), WORLD_SIZE=str(nproc),
                           MASTER_ADDR="localhost", MASTER_PORT=str(port),
                           LOCAL_RANK=str(rank),
                           LOCAL_WORLD_SIZE=str(nproc))
            cmd = [sys.executable, "-m",
                   "radar_tpu_torch.scripts.run_multiprocess", "--worker",
                   "--nproc", str(nproc), "--out", out if rank == 0 else "",
                   *mode] + (["--cpu"] if args.cpu else [])
            paths.append(os.path.join(args.logdir,
                                      f"{tag}_{nproc}_{rank}.log"))
            logs.append(open(paths[-1], "w"))
            procs.append(subprocess.Popen(cmd, env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT,
                                          cwd=REPO))
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline and any(
                p.poll() is None for p in procs):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for lf in logs:
            lf.close()
    rcs = [p.returncode for p in procs]
    report = None
    if not any(rcs) and os.path.exists(out):
        with open(out) as fh:
            report = json.load(fh)
    return rcs, report, paths


def _echo(paths, rcs, only=None):
    for rank, path in enumerate(paths):
        with open(path) as fh:
            text = fh.read()
        if only is None:
            print(f"----- worker {rank} (rc={rcs[rank]}) -----")
            sys.stdout.write(text)
        else:
            sys.stdout.write("".join(ln for ln in text.splitlines(True)
                                     if only in ln))


def _record(args) -> dict:
    import torch

    device = "cpu" if args.cpu else "cuda"
    return {"device": device_record(device), "threads_per_process": 1,
            "cpu_cores": os.cpu_count(),
            "cards": 0 if args.cpu else torch.cuda.device_count()}


def orchestrate(args) -> dict:
    rcs, report, paths = launch(args, args.nproc, [], "mp_parity")
    ok = report is not None
    _echo(paths, rcs, None if not ok else "PARITY")
    out = {"multiprocess_parity": ok, "nproc": args.nproc, "rcs": rcs,
           **(report or {}), **_record(args)}
    write_json(args.out, out)
    if not ok:
        raise SystemExit(f"multiprocess parity failed: return codes {rcs}")
    return out


def _arms(args, mode: list, tag: str) -> dict:
    arms = {}
    for n in sorted({int(x) for x in args.arms.split(",")}):
        rcs, report, paths = launch(args, n, mode, tag)
        if report is None:
            _echo(paths, rcs)
            raise SystemExit(f"{tag}: the {n}-process arm failed: return "
                             f"codes {rcs}")
        arms[n] = report
    return arms


def bench_orchestrate(args) -> dict:
    mode = ["--bench", "--trials-per-proc", str(args.trials_per_proc),
            "--bench-reps", str(args.bench_reps)] + \
        (["--perf"] if args.perf else [])
    arms = _arms(args, mode, "mp_bench")
    n1 = min(arms)
    base = arms[n1]["trials_per_s"] / n1
    curve = {str(n): {"trials_per_s": round(a["trials_per_s"], 4),
                      "speedup": round(a["trials_per_s"] / (base * n1), 4),
                      "efficiency": round(a["trials_per_s"] / n / base, 4)}
             for n, a in arms.items()}
    print(json.dumps({n: c["efficiency"] for n, c in curve.items()}))
    out = {"arms": {str(n): a for n, a in arms.items()}, "curve": curve,
           "per_proc_trials": args.trials_per_proc,
           "config": "perf small" if args.perf else "stream small",
           "note": ("ranks on the CPU, one thread each: points with more "
                    "processes than cores measure core contention"
                    if args.cpu else SHARED_CARD
                    if _record(args)["cards"] < max(arms) else
                    "a card per process"),
           **_record(args)}
    write_json(args.out, out)
    return out


def streaming_orchestrate(args) -> dict:
    mode = ["--streaming", "--scenes", str(args.scenes),
            "--targets-per-scene", str(args.targets_per_scene),
            "--trials-per-scene", str(args.trials_per_scene),
            "--seed", str(args.seed)] + (["--perf"] if args.perf else [])
    arms = _arms(args, mode, "mp_stream")
    n1 = min(arms)
    parity = all(arms[n][k] == arms[n1][k] for n in arms for k in STAT_KEYS)
    for n, a in arms.items():
        print(f"n={n}: {a['targets_per_s']:.0f} targets/s, "
              f"rate={a['detection_rate']:.4f} "
              f"walls={[round(w, 3) for w in a['walls_per_worker_s']]}")
    out = {"parity_exact_across_arms": parity,
           "arms": {str(n): a for n, a in arms.items()},
           "speedup_vs_n1": {str(n): round(a["targets_per_s"]
                                           / arms[n1]["targets_per_s"], 3)
                             for n, a in arms.items()},
           "note": ("scene-strided shared-nothing trials, records gathered "
                    "across the process group; the reference's parfor "
                    "boundary (main_plot_snr_vs_angle_error.m:167)"),
           "timing_caveat": ("ranks on the CPU, one thread each"
                             if args.cpu else SHARED_CARD
                             if _record(args)["cards"] < max(arms) else
                             "a card per process"),
           **_record(args)}
    print(json.dumps({"parity_exact_across_arms": parity,
                      "speedup_vs_n1": out["speedup_vs_n1"]}))
    write_json(args.out, out)
    if not parity:
        raise SystemExit("the streaming arms' statistics differ")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo CPU ranks in place of the card")
    ap.add_argument("--worker", action="store_true",
                    help="(internal) run as one worker of a launch")
    ap.add_argument("--bench", action="store_true",
                    help="weak-scaling throughput arms")
    ap.add_argument("--streaming", action="store_true",
                    help="scene-strided streaming Monte-Carlo arms, "
                         "bit-equal across arms")
    ap.add_argument("--perf", action="store_true",
                    help="--bench/--streaming: the perf configuration "
                         "(K1 and K2 on the card)")
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--arms", default="1,2,4",
                    help="comma-separated process counts of --bench and "
                         "--streaming")
    ap.add_argument("--trials-per-proc", type=int, default=16)
    ap.add_argument("--bench-reps", type=int, default=3)
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--targets-per-scene", type=int, default=8)
    ap.add_argument("--trials-per-scene", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a launch may take before its processes "
                         "are killed")
    ap.add_argument("--logdir", default=os.path.join(REPO, "build",
                                                     "run_multiprocess"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out is None and not args.worker:
        name = ("streaming_mc_multiproc_torch.json" if args.streaming
                else "multiprocess_scaling_torch.json" if args.bench
                else "multiprocess_parity_torch.json")
        args.out = artifact_path(name, args.cpu)
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.worker:
        return worker_main(args)
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --cpu for a host run")
    if args.streaming:
        return streaming_orchestrate(args)
    if args.bench:
        return bench_orchestrate(args)
    return orchestrate(args)


if __name__ == "__main__":
    rc = main()
    sys.exit(rc if isinstance(rc, int) else 0)
