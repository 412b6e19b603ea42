"""Multi-process bring-up — port of ``radar_tpu/parallel/multihost.py``.

Each process calls :func:`initialize` once (or is started by
:func:`run_ranks`), builds the global mesh with :func:`make_multihost_mesh`
(``dp`` outermost, so the cheap batch gather spans hosts and the
latency-bound ``ch``/``cpi`` collectives stay within one), and runs the
sharded pipeline (``parallel/sharded.py``, ``parallel/dp.py``) on its
shard.

:func:`run_ranks` is the one-host launcher, the counterpart of
``scripts/run_multiprocess.py``'s orchestrator: ``spawn``-started processes
that meet through a ``FileStore`` in a temporary directory (no port), rank
r on card ``r % device_count``. The backend follows the layout
(:func:`choose_backend`). A rank that raises, dies or outlives the timeout
makes the launcher kill every rank and raise, so a hung rank never hangs
its caller.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import AXIS_DP, Mesh, make_mesh


def choose_backend(device, ranks_per_host: int) -> str:
    """``nccl`` when every rank of a host has a card of its own, else
    ``gloo`` (ranks sharing a card, or CPU ranks)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if ranks_per_host <= torch.cuda.device_count() else "gloo"


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None, *,
               backend: str | None = None, device="cuda") -> bool:
    """Initialise the default process group if multi-process coordinates
    are available. Resolution order: the arguments, then the standard
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``
    for ``env://``, ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` for the card and the
    backend). Returns True when a process group is up, False for a single
    process with nothing configured (as JAX's at :42-44). Idempotent."""
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if init_method is None and world_size is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError("a process group needs an init method (or "
                         "MASTER_ADDR/MASTER_PORT), a world size and a rank")
    local_rank = int(env.get("LOCAL_RANK", rank))
    if backend is None:
        backend = choose_backend(
            device, int(env.get("LOCAL_WORLD_SIZE", world_size)))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def make_multihost_mesh(dp: int | None = None, ch: int = 1, cpi: int = 1,
                        *, device="cuda") -> Mesh:
    """The global mesh over every rank, dp-major: ``dp`` (trials and frame
    batches, whose only collective is a final gather) is the outer axis,
    ``ch``/``cpi`` stay within a host. ``dp=None`` takes the ranks that
    remain."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        if n % (ch * cpi):
            raise ValueError(f"{n} ranks not divisible by ch*cpi={ch * cpi}")
        dp = n // (ch * cpi)
    return make_mesh(dp, ch, cpi, device=device)


def local_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """Half-open slice of the global dp batch that this rank owns."""
    dp = mesh.shape[AXIS_DP]
    if global_batch % dp:
        raise ValueError(f"batch {global_batch} not divisible by dp={dp}")
    per = global_batch // dp
    d = mesh.coords[AXIS_DP]
    return slice(d * per, (d + 1) * per)


def _rank_main(rank, world_size, store_path, backend, device_type, timeout,
               fn, args, results):
    """Body of one spawned rank: join the group, run ``fn``, report. One
    intra-op thread per rank: the ranks share the host's cores."""
    try:
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, True, fn(*args)))
    except Exception:                      # reported; the launcher raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, device="cuda",
              backend: str | None = None, timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` as ``world_size`` ranks on this host and return
    each rank's result, in rank order.

    ``fn`` must be importable by name in a fresh interpreter (a module-level
    function of an importable module), and its result picklable (numpy
    arrays or CPU tensors). ``device="cuda"`` puts rank r on card ``r %
    device_count`` (several ranks may share a card); ``"cpu"`` runs CPU
    ranks, one intra-op thread each. ``backend`` defaults to
    :func:`choose_backend`. Raises
    ``RuntimeError`` when a rank raises or dies, ``TimeoutError`` when the
    ranks have not all returned within ``timeout`` seconds; either way every
    rank is killed first."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                           "available")
    if backend is None:
        backend = choose_backend(device, world_size)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="run_ranks_")
    results = ctx.Queue()
    procs = []
    deadline = time.monotonic() + timeout
    try:
        for rank in range(world_size):
            p = ctx.Process(
                target=_rank_main, daemon=True,
                args=(rank, world_size, os.path.join(tmp, "store"), backend,
                      device_type, timeout, fn, args, results))
            p.start()
            procs.append(p)
        done = {}
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: {fn.__name__} did not return on all "
                    f"{world_size} ranks within {timeout} s (returned: "
                    f"{sorted(done)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: rank {dead[0][0]} exited "
                                       f"with code {dead[0][1]} without a "
                                       f"result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} of {world_size} "
                                   f"raised in {fn.__name__}:\n{value}")
            done[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, min(10.0, deadline - time.monotonic())))
        return [done[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
