"""Rank programs that drive the multi-device layer and hold it against
single-rank runs — the port's counterpart of ``__graft_entry__.py::
dryrun_multichip``, in SPMD form.

Each function here is the body of every rank of a :func:`multihost.
run_ranks` launch (``tests/test_torch_parallel.py``, ``test_torch_ring.py``
and ``test_torch_dp.py`` launch them as gloo ranks on the CPU, passing
``device="cpu"``): it builds its meshes, runs, and returns picklable host
results. Like the port's other entry points they default to the card.
They live in the package, not in ``tests/``, so that a spawned rank
imports them without importing the tests' JAX.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..config.params import perf_config, small_test_config
from ..pipeline.driver import frame_seed
from ..pipeline.frame import make_frame_processor
from ..pipeline.montecarlo import make_trial_fn, snr_sweep
from ..pipeline.streaming import run_streaming_mc
from ..sim.scenario import TargetBatch
from ..waveform.precompute import precompute
from .collectives import (covariance_snapshot_sharded, dbf_channel_sharded,
                          gather_along, mtd_cpi_sharded,
                          pulse_compress_range_sharded, shard_along)
from .dp import (make_dp_frame_processor, make_dp_sharded_frame_processor,
                 make_dp_trial_fn)
from .mesh import AXES, make_mesh
from .multihost import initialize, local_batch_slice, make_multihost_mesh
from .pallas_ring import halo_right_permute
from .sharded import make_sharded_frame_processor

FIELDS = ("range_m", "velocity_ms", "angle_deg", "power", "valid")


def host_result(res) -> dict:
    """A FrameResult (or a batch of them) as host arrays."""
    out = {f: getattr(res.targets, f).cpu().numpy() for f in FIELDS}
    out["num_raw"] = res.num_raw_detections.cpu().numpy()
    out["num_final"] = res.num_final.cpu().numpy()
    return out


def raise_on(rank: int) -> int:
    """Rank ``rank`` raises; the others return their rank."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} raises on purpose")
    return dist.get_rank()


def sleep_on(rank: int, seconds: float) -> int:
    """Rank ``rank`` sleeps ``seconds``; the others return their rank."""
    if dist.get_rank() == rank:
        time.sleep(seconds)
    return dist.get_rank()


def layout(device="cuda") -> dict:
    """Coordinates, groups and transport of a (2, 2, 2) mesh; the sum of
    the global ranks over each group; the multihost mesh of ch=2 and its
    batch slice (8 ranks)."""
    mesh = make_mesh(2, 2, 2, device=device)
    groups = [(a,) for a in AXES] + [("dp", "cpi"), AXES]
    one = torch.tensor([mesh.rank], dtype=torch.int64, device=mesh.device)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords),
           "backend": mesh.backend, "staging": mesh.staging,
           "device": str(mesh.device),
           "group_ranks": {g: mesh.group_ranks(g) for g in groups},
           "group_sums": {g: int(mesh.all_reduce(one, g)) for g in groups},
           "initialize": initialize()}
    mh = make_multihost_mesh(ch=2, device=device)
    out["multihost_shape"] = dict(mh.shape)
    out["batch_slice"] = local_batch_slice(8, mh)
    try:
        local_batch_slice(6, mh)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def collectives(iq, w, pc, mtd_win, x_cov, device="cuda") -> dict:
    """``dbf_channel_sharded`` (ch=4), ``mtd_cpi_sharded`` (cpi=4, with an
    inert dp=2) and ``covariance_snapshot_sharded`` (cpi=8) on 8 ranks;
    the whole results."""
    m_ch = make_mesh(dp=2, ch=4, device=device)
    dbf = dbf_channel_sharded(m_ch, "ch")(shard_along(iq, m_ch, "ch", 2),
                                          shard_along(w, m_ch, "ch", 1))
    m_cpi = make_mesh(dp=2, cpi=4, device=device)
    rdm = mtd_cpi_sharded(m_cpi, mtd_win)(shard_along(pc, m_cpi, "cpi", 0))
    m8 = make_mesh(cpi=8, device=device)
    cov = covariance_snapshot_sharded(m8)(shard_along(x_cov, m8, "cpi", 1))
    return {"dbf": dbf.cpu().numpy(),
            "mtd": gather_along(rdm, m_cpi, "cpi", 0).cpu().numpy(),
            "cov": cov.cpu().numpy()}


def ring(x_halo, halo: int, pc_cases: dict, device="cuda") -> dict:
    """The halo exchange of ``x_halo`` [rows, S] on a ring of every rank
    (each rank's halo, in cpi order along the columns), the overlap-save
    route's FFT inputs (``nfft`` = s_local + halo + 3, each rank's in cpi
    order along the columns), then ``pulse_compress_range_sharded`` with
    both transports for each case ``name: ((dp, ch, cpi), x, taps,
    nfft)``; the whole outputs."""
    mesh = make_mesh(cpi=dist.get_world_size(), device=device)
    xl = shard_along(x_halo, mesh, "cpi", 1)
    ex = halo_right_permute(mesh, xl.shape[0], xl.shape[1], halo,
                            dtype=xl.dtype, nfft=xl.shape[1] + halo + 3)
    out = {"halo": gather_along(ex(xl), mesh, "cpi", 1).cpu().numpy(),
           "os_input": gather_along(ex.overlap_save_input(xl), mesh, "cpi",
                                    1).cpu().numpy()}
    ex.close()
    for name, (shape, x, taps, nfft) in pc_cases.items():
        m = make_mesh(*shape, device=device)
        xl = shard_along(x, m, "cpi", 1)
        out[name] = {}
        for impl in ("ppermute", "rdma"):
            f = pulse_compress_range_sharded(m, taps, nfft, halo_impl=impl)
            out[name][impl] = gather_along(f(xl), m, "cpi", 1).cpu().numpy()
            f.close()
    return out


def _targets_batch(n: int) -> TargetBatch:
    """n single-target scenes on a leading batch axis (tests/test_dp.py's
    ``_batched_targets``)."""
    return TargetBatch(range_m=(3000.0 + 500.0 * np.arange(n))[:, None],
                       velocity_ms=np.full((n, 1), 12.0),
                       elevation_deg=np.full((n, 1), 9.0),
                       snr_db=np.full((n, 1), 20.0))


def frames(device="cuda") -> dict:
    """The frame processors and Monte-Carlo mesh routes on 4 ranks at small
    widths, with the single-rank runs they must equal, each computed on one
    rank (rank r computes the single-rank frames j with j % 4 == r)."""
    rank = dist.get_rank()
    out = {"sharded": {}, "single": {}, "dp": {}, "dp_single": {},
           "errors": {}}
    tb = TargetBatch.make([3000.0, 9000.0], [10.0, 20.0], [10.0, 5.0],
                          [18.0, 15.0])
    base = small_test_config(channels=8, pulses=32)
    cfgs = {"stream": base,
            "lowrank": base.replace(fused_synth_dbf=True, lowrank_rdm=True),
            "perf": perf_config(small_test_config()),
            "perf_xla": perf_config(small_test_config(), pallas=False)}
    pre = {k: precompute(c) for k, c in cfgs.items()}

    # one frame sharded over (1, 2, 2) and (2, 1, 2), both streams
    for shape in ((1, 2, 2), (2, 1, 2)):
        mesh = make_mesh(*shape, device=device)
        for name in ("stream", "lowrank"):
            proc = make_sharded_frame_processor(cfgs[name], mesh, pre[name])
            out["sharded"][(shape, name)] = host_result(proc(7, tb))
    if rank == 0:
        for name in ("stream", "lowrank"):
            out["single"][name] = host_result(make_frame_processor(
                cfgs[name], pre[name], device=device)(7, tb))

    # batches of frames: dp=4 (kernel route), dp=2 x ch=2 (xla route, ch
    # inert), dp=2 x ch=2 sharded frames
    seeds = [frame_seed(5, i) for i in range(8)]
    batches = (("perf", make_mesh(dp=4, device=device), 8,
                make_dp_frame_processor),
               ("perf_xla", make_mesh(dp=2, ch=2, device=device), 4,
                make_dp_frame_processor),
               ("stream", make_mesh(dp=2, ch=2, device=device), 4,
                make_dp_sharded_frame_processor))
    for name, mesh, n, maker in batches:
        proc = maker(cfgs[name], mesh, pre[name])
        label = f"{name}:{maker.__name__}"
        out["dp"][label] = host_result(proc(seeds[:n], _targets_batch(n)))
        single = make_frame_processor(cfgs[name], pre[name], device=device)
        tbs = _targets_batch(n)
        for j in range(rank, n, dist.get_world_size()):
            out["dp_single"][(label, j)] = host_result(single(
                seeds[j], TargetBatch(*(x[j] for x in tbs))))
        try:                        # 5 frames: indivisible by 2 and 4
            proc(seeds[:5], _targets_batch(5))
        except ValueError as e:
            out["errors"][label] = str(e)

    # dp trials, the sweep and the streaming MC
    m4 = make_mesh(dp=4, device=device)
    t1 = TargetBatch.make([3000.0], [10.0], [9.0], [20.0])
    angles, hits = make_dp_trial_fn(cfgs["perf"], m4, pre["perf"])(
        t1, seeds)
    out["trials"] = (angles.cpu().numpy(), hits.cpu().numpy())
    sw_cfg = perf_config(small_test_config(channels=8, pulses=32))
    sw_pre = precompute(sw_cfg)
    sw_kw = dict(snr_db_vector=[-42.0, 25.0], num_trials=8,
                 truth=TargetBatch.make([3000.0], [10.0], [10.0], [0.0]),
                 seed=11, batch_size=4, precomp=sw_pre)
    out["sweep"] = snr_sweep(sw_cfg, mesh=m4, **sw_kw).errors
    try:
        snr_sweep(sw_cfg, mesh=m4, **dict(sw_kw, num_trials=6,
                                          batch_size=3))
    except ValueError as e:
        out["errors"]["sweep"] = str(e)
    st_kw = dict(num_scenes=2, targets_per_scene=4, trials_per_scene=4,
                 seed=3, snr_range=(-5.0, 20.0))
    out["streaming_dp"] = run_streaming_mc(
        sw_cfg, mesh=m4, dp_trials=True, precomp=sw_pre, **st_kw)
    m122 = make_mesh(1, 2, 2, device=device)
    out["streaming_sharded"] = run_streaming_mc(
        base, mesh=m122, precomp=pre["stream"], **st_kw)
    try:
        run_streaming_mc(sw_cfg, mesh=m4, store=object(), **st_kw)
    except NotImplementedError as e:
        out["errors"]["store"] = str(e)
    if rank == 1:
        out["trials_single"] = tuple(
            x.cpu().numpy() for x in make_trial_fn(
                cfgs["perf"], pre["perf"], device=device)(t1, seeds))
        out["sweep_single"] = snr_sweep(sw_cfg, device=device,
                                        **sw_kw).errors
    if rank == 2:
        out["streaming_dp_single"] = run_streaming_mc(
            sw_cfg, precomp=sw_pre, device=device, **st_kw)
    if rank == 3:
        out["streaming_sharded_single"] = run_streaming_mc(
            base, precomp=pre["stream"], device=device, **st_kw)
    return out


def k6_check(cases, calls: int = 6, device="cuda") -> dict:
    """K6 against its plain versions on a ring of every rank, on the card:
    for each ``(rows, s_local, halo, dtype, nfft)`` case, ``calls`` rounds
    of fresh data, each an exchange through the ``[rows, halo]`` contract
    and one through the overlap-save route (each receive slot used
    ``calls`` times); whether each result equals the plain ring's (and its
    ``cat`` + zero pad) bit for bit, and K6's push and fill launches."""
    from . import pallas_ring

    mesh = make_mesh(cpi=dist.get_world_size(), device=device)
    g = torch.Generator(device=mesh.device).manual_seed(mesh.rank)
    out = {"equal": [], "os_equal": [], "launches": [], "fills": []}
    for rows, s_local, halo, dtype, nfft in cases:
        with halo_right_permute(mesh, rows, s_local, halo, dtype=dtype,
                                nfft=nfft) as ex:
            pushes = pallas_ring.k6_launch_count
            fills = pallas_ring.k6_fill_count
            for _ in range(calls):
                fresh = lambda: torch.randn((rows, s_local), generator=g,
                                            device=mesh.device, dtype=dtype)
                x = fresh()
                got = ex(x)
                want = pallas_ring.halo_right_plain(x, mesh, halo)
                out["equal"].append(bool(torch.equal(got, want)))
                x = fresh()
                got = ex.overlap_save_input(x)
                want = pallas_ring.overlap_save_input_plain(x, mesh, halo,
                                                            nfft)
                out["os_equal"].append(bool(torch.equal(got, want)))
            ex.check()
            out["launches"].append(pallas_ring.k6_launch_count - pushes)
            out["fills"].append(pallas_ring.k6_fill_count - fills)
    return out


def k6_timeout(timeout_s: float, device="cuda") -> str:
    """Rank 0 exchanges on a ring whose other rank never does: K6's bounded
    wait must make it raise (at ``check()``: the call itself does not wait
    for the card); returns rank 0's error ("" elsewhere)."""
    mesh = make_mesh(cpi=dist.get_world_size(), device=device)
    ex = halo_right_permute(mesh, 8, 16, 4, timeout_s=timeout_s)
    message = ""
    if mesh.rank == 0:
        try:
            ex(torch.ones((8, 16), device=mesh.device))
            ex.check()
        except RuntimeError as e:
            message = str(e)
    ex.close()
    return message
