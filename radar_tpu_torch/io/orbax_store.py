"""Frame-keyed array checkpoints on ``torch.distributed.checkpoint`` — the
counterpart of ``radar_tpu/io/orbax_store.py:32`` (SURVEY.md section 5.4).

Orbax is a JAX library and is absent here; the class keeps the name
``OrbaxFrameStore`` so a reader finds the counterpart, and its surface:
``root``, ``save(frame_idx, tree)``, ``restore(frame_idx)``, ``has`` and
``frames_done``, in the same ``root/frame_%06d`` layout. A ``tree`` is a
flat mapping of names to arrays (numpy or tensors, on any device); a
restore gives host numpy arrays of the saved shapes and dtypes, read from
the checkpoint's metadata. Bool and integer arrays keep their dtype.

``torch.distributed.checkpoint`` writes the ``.metadata`` file of a
checkpoint last, so ``frames_done`` counts only the directories that hold
it: a save killed mid-write does not count as done.

Without ``mesh=`` a save or a restore runs in one process, with no process
group. With ``mesh=`` (a ``parallel.mesh.Mesh``; every rank calls) the
tree holds this rank's rows of a batch axis: ``save`` writes each rank's
own rows, over a gloo group of the mesh's ranks, and no rank gathers the
batch. Each chunk is saved under ``name@start:stop``, its global rows, so
``restore(mesh=, axis=)`` can give each rank exactly its block of the rows
under the *current* mesh, which may split them otherwise than the mesh
that saved them (the elastic dp=4 -> dp=2 resume; JAX's ``like=`` restore,
``radar_tpu/io/orbax_store.py:56-83``). ``torch.distributed.
device_mesh``'s resharding is not used (``parallel/mesh.py``).
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import warnings

import numpy as np
import torch

_FRAME_RE = re.compile(r"^frame_(\d+)$")
_CHUNK_RE = re.compile(r"^(.+)@(\d+):(\d+)$")


def _tensor(x) -> torch.Tensor:
    """A contiguous CPU tensor of ``x``'s values and dtype."""
    if torch.is_tensor(x):
        return x.detach().cpu().contiguous()
    return torch.from_numpy(np.array(x, order="C"))


@contextlib.contextmanager
def _one_process():
    """Silences the checkpointer's notice that it runs in one process,
    which is this store's design for one-process saves and for every
    rank's own reads."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled")
        yield


def _chunks(meta) -> dict:
    """``{name: [(start, stop, key, size, dtype), ...]}`` in row order from
    a checkpoint's metadata; a key saved without a mesh is the chunk of all
    its rows (or of its scalar)."""
    out = {}
    for key, m in meta.state_dict_metadata.items():
        size = tuple(m.size)
        hit = _CHUNK_RE.match(key)
        if hit:
            name, start, stop = hit.group(1), int(hit.group(2)), \
                int(hit.group(3))
        else:
            name, start, stop = key, 0, (size[0] if size else None)
        out.setdefault(name, []).append((start, stop, key, size,
                                         m.properties.dtype))
    for name, parts in out.items():
        parts.sort(key=lambda p: p[0])
        edge = 0
        for start, stop, *_ in parts:
            if stop is not None and start != edge:
                raise ValueError(f"checkpoint rows of {name!r} are not "
                                 f"contiguous: a chunk starts at {start}, "
                                 f"the rows before end at {edge}")
            edge = stop
    return out


class OrbaxFrameStore:
    """Frame-keyed checkpoints of flat array mappings."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, frame_idx: int) -> str:
        return os.path.join(self.root, f"frame_{frame_idx:06d}")

    def save(self, frame_idx: int, tree: dict, *, mesh=None,
             axis="dp") -> str:
        """Write ``tree`` under ``frame_idx``, replacing a checkpoint
        there. With ``mesh`` (every rank calls): ``tree`` is this rank's
        block of rows along ``axis`` of the mesh (blocks in the order of
        the axis index), or, with ``axis=None``, the same whole rows on
        every rank (written once)."""
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        path = self._path(frame_idx)
        if mesh is None:
            if os.path.exists(path):
                shutil.rmtree(path)
            with _one_process():
                dcp.save({k: _tensor(v) for k, v in tree.items()},
                         checkpoint_id=path, no_dist=True)
            return path
        rows = {len(v) for v in tree.values()}
        if len(rows) != 1:
            raise ValueError(f"a rank's tree must hold one row count along "
                             f"the batch axis, got {sorted(rows)}")
        n = rows.pop()
        start = 0
        if axis is not None:
            counts = mesh.all_gather_object(n, axis)
            start = sum(counts[:mesh.index(axis)])
        state = {f"{k}@{start}:{start + n}": _tensor(v)
                 for k, v in tree.items()}
        group = mesh.host_group()
        if mesh.rank == 0 and os.path.exists(path):
            shutil.rmtree(path)
        dist.barrier(group=group)
        dcp.save(state, checkpoint_id=path, process_group=group)
        return path

    def restore(self, frame_idx: int, *, mesh=None,
                axis="dp") -> dict[str, np.ndarray]:
        """The arrays saved under ``frame_idx``, as host numpy: all their
        rows, or with ``mesh`` this rank's block of them along ``axis``
        under this mesh (rows / axis size each, in axis order), whatever
        mesh saved them. Each rank reads only the chunks its block
        overlaps; no collective runs."""
        import torch.distributed.checkpoint as dcp

        path = self._path(frame_idx)
        chunks = _chunks(dcp.FileSystemReader(path).read_metadata())
        want = {}
        for name, parts in chunks.items():
            total = parts[-1][1]
            lo, hi = 0, total
            if mesh is not None and axis is not None and total is not None:
                n_ax = mesh.size(axis)
                if total % n_ax:
                    raise ValueError(f"{total} saved rows of {name!r} do "
                                     f"not split over {axis}={n_ax}")
                per = total // n_ax
                lo = mesh.index(axis) * per
                hi = lo + per
            want[name] = (lo, hi, [p for p in parts if p[1] is None
                                   or lo == hi            # no rows
                                   or (p[0] < hi and p[1] > lo)])
        state = {key: torch.empty(size, dtype=dtype)
                 for _, _, parts in want.values()
                 for _, _, key, size, dtype in parts}
        with _one_process():
            dcp.load(state, checkpoint_id=path, no_dist=True)
        out = {}
        for name, (lo, hi, parts) in want.items():
            if parts[0][1] is None:                       # a scalar
                out[name] = state[parts[0][2]].numpy()
                continue
            out[name] = torch.cat([
                state[key][max(lo - start, 0):min(hi, stop) - start]
                for start, stop, key, _, _ in parts]).numpy()
        return out

    def has(self, frame_idx: int) -> bool:
        return os.path.exists(os.path.join(self._path(frame_idx),
                                           ".metadata"))

    def frames_done(self) -> list[int]:
        """Sorted frame indices with complete checkpoints: the resume
        point (the contract of ``CheckpointStore.frames_done``)."""
        done = []
        for name in os.listdir(self.root):
            m = _FRAME_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name,
                                                 ".metadata")):
                done.append(int(m.group(1)))
        return sorted(done)
