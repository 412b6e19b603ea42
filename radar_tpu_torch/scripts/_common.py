"""Helpers shared by the port's command-line scripts: the device a run
takes, the record of the card it ran on, the default artifact paths, the
matplotlib check of a figure asked for, and the kernels' launch counters.

Every script runs on the card unless ``--cpu`` is given; without a card it
exits before any work. Its JSON goes to ``results/<name>`` on the card and
to ``build/<name>`` on the host, never to the path of a JAX artifact.
``--dp N`` (the sweep and the streaming MC) runs the study as N ranks on
the mesh route (:func:`run_dp`).
"""

from __future__ import annotations

import json
import os
import subprocess

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pick_device(cpu: bool) -> torch.device:
    """The card unless ``cpu``; no card when one was asked for raises."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu for a host smoke run")
    return torch.device("cuda")


def device_record(device) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    index = device.index or 0
    try:
        limit = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        limit = "power limit not read"
    return f"{torch.cuda.get_device_name(index)}, {limit}"


def artifact_path(name: str, host: bool) -> str:
    """``results/<name>`` for a run on the card, ``build/<name>`` for a
    host run (``--cpu``) or a shrunk one."""
    return os.path.join(REPO, "build" if host else "results", name)


def require_matplotlib(flag: str) -> None:
    """A figure was asked for (``flag``): exit naming matplotlib where it
    is missing (the card's machine has none), before any frame runs."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"{flag} needs matplotlib, which is missing: {e}"
                         ) from None


def kernel_launches() -> dict:
    """The launch counters of the kernels a script's path can reach: K1
    (noise RDM), K1c's planes inside K1's draw mode and as
    ``gen_noise_planes``, K2 and K3 (CFAR), K5 (AWGN) and the connected
    labels (``labels``), each its wrapper's calls; and the frame tail's
    CUDA graphs captured and replayed on a card (a replay runs the tail's
    K2 or K3 and labels without a call of their wrappers)."""
    from ..cluster import connected
    from ..ops import awgn, cfar_kernel, noise_rdm
    from ..pipeline import frame

    return {"K1": noise_rdm.launch_count,
            "K1c": noise_rdm.k1c_launch_count
            + noise_rdm.k1c_draw_launch_count,
            "K2": cfar_kernel.launch_count,
            "K3": cfar_kernel.k3_launch_count,
            "K5": awgn.launch_count,
            "labels": connected.launch_count,
            "tail_captures": frame.tail_graph_captures,
            "tail_replays": frame.tail_graph_replays}


def launches_since(before: dict) -> dict:
    """The launches of each kernel since ``kernel_launches()`` gave
    ``before``."""
    return {k: v - before[k] for k, v in kernel_launches().items()}


# a --dp run's bound: run_ranks kills every rank and raises past it, so a
# hung rank never hangs the script
DP_TIMEOUT_S = 24 * 3600.0


def _dp_rank(run, args, device_type: str) -> dict:
    """One rank of a ``--dp`` run: ``run(args, device, mesh=)`` on a dp
    mesh of every rank."""
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(dp=args.dp, device=device_type)
    return run(args, mesh.device, mesh=mesh)


def run_dp(run, args, device) -> dict:
    """A script's ``run(args, device, mesh=)`` on ``args.dp`` ranks of this
    host through ``parallel.multihost.run_ranks`` (gloo when they share
    one card, ``choose_backend``); rank 0's report (rank 0 writes the
    JSON)."""
    from ..parallel.multihost import run_ranks

    device = torch.device(device)
    return run_ranks(_dp_rank, args.dp, run, args, device.type,
                     device=device.type, timeout=DP_TIMEOUT_S)[0]


def ranks_launches(launches: dict, mesh) -> dict:
    """Each kernel's launches summed over the ranks of ``mesh``, and the
    list a rank (``mesh=None``: this process's ``launches``)."""
    if mesh is None:
        return {"launches": launches}
    from ..parallel.mesh import AXES

    per = mesh.all_gather_object(launches, AXES)
    return {"launches": {k: sum(p[k] for p in per) for k in launches},
            "launches_per_rank": per}


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
    print("wrote", path, flush=True)
