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
it: a save killed mid-write does not count as done. Saves and restores run
in one process, with no process group. Not ported: the sharded restore
with ``like=`` and the elastic dp=4 -> dp=2 resume (ROADMAP Queue 1 item
14).
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


def _tensor(x) -> torch.Tensor:
    """A contiguous CPU tensor of ``x``'s values and dtype."""
    if torch.is_tensor(x):
        return x.detach().cpu().contiguous()
    return torch.from_numpy(np.array(x, order="C"))


@contextlib.contextmanager
def _one_process():
    """Silences the checkpointer's notice that it runs in one process,
    which is this store's design."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled")
        yield


class OrbaxFrameStore:
    """Frame-keyed checkpoints of flat array mappings."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, frame_idx: int) -> str:
        return os.path.join(self.root, f"frame_{frame_idx:06d}")

    def save(self, frame_idx: int, tree: dict) -> str:
        """Write ``tree`` under ``frame_idx``, replacing a checkpoint
        there."""
        import torch.distributed.checkpoint as dcp

        path = self._path(frame_idx)
        if os.path.exists(path):
            shutil.rmtree(path)
        with _one_process():
            dcp.save({k: _tensor(v) for k, v in tree.items()},
                     checkpoint_id=path, no_dist=True)
        return path

    def restore(self, frame_idx: int) -> dict[str, np.ndarray]:
        """The arrays saved under ``frame_idx``, as host numpy."""
        import torch.distributed.checkpoint as dcp

        path = self._path(frame_idx)
        meta = dcp.FileSystemReader(path).read_metadata()
        state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                 for k, m in meta.state_dict_metadata.items()}
        with _one_process():
            dcp.load(state, checkpoint_id=path, no_dist=True)
        return {k: v.numpy() for k, v in state.items()}

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
