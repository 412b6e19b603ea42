"""Helpers shared by the port's command-line scripts: the device a run
takes, the record of the card it ran on, the default artifact paths, the
matplotlib check of a figure asked for, and the kernels' launch counters.

Every script runs on the card unless ``--cpu`` is given; without a card it
exits before any work. Its JSON goes to ``results/<name>`` on the card and
to ``build/<name>`` on the host, never to the path of a JAX artifact.
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
    ``gen_noise_planes``, K2 and K3 (CFAR) and K5 (AWGN)."""
    from ..ops import awgn, cfar_kernel, noise_rdm

    return {"K1": noise_rdm.launch_count,
            "K1c": noise_rdm.k1c_launch_count
            + noise_rdm.k1c_draw_launch_count,
            "K2": cfar_kernel.launch_count,
            "K3": cfar_kernel.k3_launch_count,
            "K5": awgn.launch_count}


def launches_since(before: dict) -> dict:
    """The launches of each kernel since ``kernel_launches()`` gave
    ``before``."""
    return {k: v - before[k] for k, v in kernel_launches().items()}


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
    print("wrote", path, flush=True)
