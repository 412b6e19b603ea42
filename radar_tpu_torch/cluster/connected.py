"""Connected-component labeling for detection clustering — port of
``radar_tpu/cluster/connected.py:24-129``.

The reference's BFS flood fills (fun_process_single_frame.m:302-407)
become masked min-label propagation plus pointer jumping over the gate-
adjacency matrix, iterated to fixpoint. A cluster's label is its smallest
member index, so the fixpoint equals the JAX package's labels exactly.

On the card the clusterings take ``gated_labels``: the connected-labels
kernel (``csrc/connected.cu``) builds the gate graph from the fields and
runs the same step to its fixpoint in one thread block, with no host read;
CPU tensors take ``gate_adjacency`` and ``connected_labels``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span

CHECK_EVERY = 4   # propagation steps between convergence checks (host syncs)
MAX_FIELDS = 3    # gate fields the kernel takes
MAX_SLOTS = 1024  # slots the kernel takes (its bit matrix in shared memory)

launch_count = 0  # connected-labels kernel launches


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


def gated_labels(fields: list, valid: torch.Tensor) -> torch.Tensor:
    """``connected_labels(gate_adjacency(fields, valid), valid)``: labels
    [n] int64 of the components under the gates of ``fields`` [(f [n],
    gate)]. The connected-labels kernel for CUDA tensors (or it raises:
    at most ``MAX_SLOTS`` slots), the plain pair for CPU tensors."""
    if valid.is_cuda:
        return _gated_labels_cuda(fields, valid)
    return connected_labels(gate_adjacency(fields, valid), valid)


def _gated_labels_cuda(fields: list, valid: torch.Tensor) -> torch.Tensor:
    global launch_count
    from .. import _build

    n = valid.shape[0]
    if valid.dim() != 1 or not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"the kernel takes valid [n] and 1 to {MAX_FIELDS} "
                         "gate fields")
    if n > MAX_SLOTS:
        raise ValueError(f"the kernel takes at most {MAX_SLOTS} slots "
                         f"(cfar.max_detections), not {n}")
    fs = []
    for f, _ in fields:
        if f.dtype != torch.float32 or f.shape != (n,) \
                or f.device != valid.device:
            raise ValueError("the kernel takes f32 gate fields [n] on the "
                             "device of valid")
        fs.append(f.contiguous())
    labels = torch.empty(n, dtype=torch.int64, device=valid.device)
    if n == 0:
        return labels
    valid = valid.contiguous()
    pad = MAX_FIELDS - len(fs)
    lib = _build.load("connected")
    code = lib.cc_labels(
        n, len(fs), *[f.data_ptr() for f in fs], *[None] * pad,
        # the gates rounded to f32, as the card compares a float to them
        *[float(np.float32(gate)) for _, gate in fields], *[0.0] * pad,
        valid.data_ptr(), labels.data_ptr(),
        torch.cuda.current_stream(valid.device).cuda_stream)
    _build.check(lib, code, "cc_labels")
    launch_count += 1
    return labels


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
