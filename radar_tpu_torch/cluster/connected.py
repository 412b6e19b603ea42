"""Connected-component labeling for detection clustering — port of
``radar_tpu/cluster/connected.py:24-129``.

The reference's BFS flood fills (fun_process_single_frame.m:302-407)
become masked min-label propagation plus pointer jumping over the gate-
adjacency matrix, iterated to fixpoint. A cluster's label is its smallest
member index, so the fixpoint equals the JAX package's labels exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span

CHECK_EVERY = 4   # propagation steps between convergence checks (host syncs)


def connected_labels(adj: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Labels [n] int64: smallest member index of each component; invalid
    slots get label n. Steps past the fixpoint change nothing, so
    convergence is tested only every ``CHECK_EVERY`` steps (each test is
    one device-to-host read)."""
    n = adj.shape[0]
    dev = adj.device
    idx = torch.arange(n, device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    a = (adj & valid[None, :] & valid[:, None]) | (eye & valid[None, :])
    big = torch.full((), n, dtype=torch.int64, device=dev)
    labels = torch.where(valid, idx, big)

    def step(lab):
        nb = torch.where(a, lab[None, :], big)
        new = torch.minimum(lab, nb.min(dim=1).values)
        # pointer jumping: adopt your current representative's label
        jumped = torch.where(new < n, new, torch.zeros_like(new))
        return torch.minimum(new, torch.where(new < n, new[jumped], big))

    while True:
        prev = labels
        for _ in range(CHECK_EVERY):
            labels = step(labels)
        if _converged(labels, prev):
            return labels


def _converged(labels: torch.Tensor, prev: torch.Tensor) -> bool:
    """Whether no label moved: one read of a device value (``rt.sync``)."""
    changed = torch.any(labels != prev)
    with span("sync"):
        return not bool(changed)


def gate_adjacency(fields: list, valid: torch.Tensor) -> torch.Tensor:
    """A[i,j] = all_k |f_k[i] - f_k[j]| <= gate_k over valid slots."""
    a = valid[None, :] & valid[:, None]
    for f, gate in fields:
        a = a & ((f[:, None] - f[None, :]).abs() <= gate)
    return a


def merge_weighted_mean(labels: torch.Tensor, valid: torch.Tensor,
                        power: torch.Tensor, fields: dict):
    """Per-component power-weighted means (stage-1 merge, ref :339-351):
    (merged fields, total power [n], rep_valid [n]) at representative
    slots (label == own index)."""
    n = labels.shape[0]
    idx = torch.arange(n, device=labels.device)
    member = (labels[None, :] == idx[:, None]) & valid[None, :]
    memberf = member.to(power.dtype)
    wsum = memberf @ power
    safe = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    merged = {k: (memberf @ (v * power)) / safe for k, v in fields.items()}
    return merged, wsum, valid & (labels == idx)


def merge_winner_take_all(labels: torch.Tensor, valid: torch.Tensor,
                          power: torch.Tensor, fields: dict):
    """Per-component winner-take-all by power (stage-2 merge, ref
    :392-406): (winner fields incl. power, rep_valid [n])."""
    n = labels.shape[0]
    idx = torch.arange(n, device=labels.device)
    member = (labels[None, :] == idx[:, None]) & valid[None, :]
    neg_inf = torch.full((), float("-inf"), dtype=power.dtype,
                         device=power.device)
    winner = torch.argmax(torch.where(member, power[None, :], neg_inf), dim=1)
    merged = {k: v[winner] for k, v in fields.items()}
    merged["power"] = power[winner]
    return merged, valid & (labels == idx)


def connected_components_np(adj: np.ndarray) -> np.ndarray:
    """Host BFS connected components of a dense bool adjacency [n, n] (the
    variable-length cumulative logs of inter-frame track association).
    Returns 0-based component ids in first-seen order, the ids the
    reference's BFS assigns."""
    n = adj.shape[0]
    comp = -np.ones(n, dtype=np.int64)
    next_id = 0
    for i in range(n):
        if comp[i] >= 0:
            continue
        stack = [i]
        comp[i] = next_id
        while stack:
            u = stack.pop()
            for v in np.nonzero(adj[u] & (comp < 0))[0]:
                comp[v] = next_id
                stack.append(v)
        next_id += 1
    return comp
