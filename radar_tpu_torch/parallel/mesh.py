"""Device mesh of the multi-device layer — port of
``radar_tpu/parallel/mesh.py``.

The port is SPMD over ``torch.distributed``: every rank (one process) runs
the same program on its own shard, on its own device. A :class:`Mesh` names
the rank's coordinates on the three axes of the JAX mesh:

  - ``dp``:  data parallel — Monte-Carlo trials / frame batches
  - ``ch``:  channel parallel — array elements; the DBF channel combine and
             the covariance become all-reduces
  - ``cpi``: slow-time (or fast-time) parallel — pulse or range blocks; the
             MTD needs the all-to-all reshard

Ranks are laid out row-major, as ``np.asarray(devices).reshape(dp, ch,
cpi)`` lays out JAX's devices: global rank ``(d * ch + c) * cpi + q`` sits
at ``(d, c, q)``. The collectives of a set of axes run on a process group
of the ranks that differ only on those axes (``dist.new_group``, created on
first use, in the same order on every rank as SPMD code guarantees).
``torch.distributed.device_mesh`` is not used: it cannot be told the
backend on every torch version the port runs on.

JAX's ``shard_map`` collectives map onto the methods here: ``psum`` →
:meth:`Mesh.all_reduce`, ``all_to_all(tiled)`` → :meth:`Mesh.all_to_all`
(``all_to_all_single``), ``ppermute`` → :meth:`Mesh.shift_right`
(``batch_isend_irecv``), the replicated tail → :meth:`Mesh.all_gather`.

Transport follows the layout, never a failure: ``nccl`` when every rank has
its own card, ``gloo`` when ranks share a card (NCCL refuses two ranks on
one device) or run on the CPU. Gloo takes only some CUDA tensors, so with
CUDA tensors on gloo every collective stages through the host explicitly
(``Mesh.staging``). Complex tensors travel as their real view, booleans as
uint8. JAX's ``replicated``/``spec`` build ``NamedSharding``s, which have no
counterpart here: a rank's tensors simply are its shard.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_CH = "ch"
AXIS_CPI = "cpi"
AXES = (AXIS_DP, AXIS_CH, AXIS_CPI)


def _axes(axes) -> tuple:
    """A mesh axis or axes as a tuple in mesh order."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in names:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}: not one of {AXES}")
    return tuple(a for a in AXES if a in names)


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``"cuda"`` is card ``rank % device_count``,
    ``"cpu"`` the CPU, an indexed device itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                           "available")
    if device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a (dp, ch, cpi) mesh, its device and the
    transport of its collectives."""

    shape: dict            # {"dp": n, "ch": n, "cpi": n}
    coords: dict           # this rank's index on each axis
    rank: int
    device: torch.device
    backend: str | None    # None: one process without a process group
    staging: bool          # gloo with CUDA tensors: collectives via host
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)

    def size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def index(self, axes) -> int:
        """This rank's row-major index within the group of ``axes``."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group_ranks(self, axes) -> list:
        """Global ranks of this rank's group over ``axes``, in group
        order."""
        names = _axes(axes)
        out = []
        for sub in itertools.product(*(range(self.shape[a]) for a in names)):
            c = dict(self.coords, **dict(zip(names, sub)))
            out.append(self._rank_of(c))
        return out

    def _rank_of(self, coords: dict) -> int:
        return ((coords[AXIS_DP] * self.shape[AXIS_CH] + coords[AXIS_CH])
                * self.shape[AXIS_CPI] + coords[AXIS_CPI])

    def group(self, axes):
        """The process group of this rank over ``axes`` (every rank creates
        every group of ``axes`` on first use, in one order)."""
        names = _axes(axes)
        if names not in self._groups:
            others = [a for a in AXES if a not in names]
            mine = None
            for sub in itertools.product(*(range(self.shape[a])
                                           for a in others)):
                anchor = dict(self.coords, **dict(zip(others, sub)))
                ranks = [self._rank_of(dict(anchor, **dict(zip(names, s))))
                         for s in itertools.product(
                             *(range(self.shape[a]) for a in names))]
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = g
            self._groups[names] = mine
        return self._groups[names]

    def host_group(self):
        """A gloo group of every rank of the mesh, for host tensors (the
        checkpoints of ``io/orbax_store.py``): the default group where it
        is gloo, else one made on first use by every rank."""
        if self.backend == "gloo":
            return dist.group.WORLD
        if "host" not in self._groups:
            self._groups["host"] = dist.new_group(backend="gloo")
        return self._groups["host"]

    # ---- collectives over the group of ``axes`` (identity on one rank)

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        if self.staging:
            x = x.cpu()
        if x.is_complex():
            x = torch.view_as_real(x)
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return x.contiguous()

    def _unwire(self, w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.is_complex():
            w = torch.view_as_complex(w)
        return w.to(device=like.device, dtype=like.dtype)

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum of ``x`` over the group (JAX's ``psum``)."""
        if self.size(axes) == 1:
            return x
        w = self._wire(x).clone()
        dist.all_reduce(w, group=self.group(axes))
        return self._unwire(w, x)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """The group's ``x`` concatenated along ``dim`` in group order."""
        n = self.size(axes)
        if n == 1:
            return x
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=self.group(axes))
        return torch.cat([self._unwire(p, x) for p in parts], dim=dim)

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x [n, ...]``: block j goes to group member j; returns ``[n,
        ...]`` whose block j came from member j (``all_to_all_single``)."""
        n = self.size(axes)
        if x.shape[0] != n:
            raise ValueError(f"all_to_all takes [{n}, ...] blocks, got "
                             f"{tuple(x.shape)}")
        if n == 1:
            return x
        w = self._wire(x)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self.group(axes))
        return self._unwire(out, x)

    def shift_right(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Member i's ``x`` delivered to member i+1 (``batch_isend_irecv``
        without wraparound, JAX's ``ppermute`` with ``[(i, i+1)]``); member
        0 receives zeros."""
        n, i = self.size(axis), self.index(axis)
        if n == 1:
            return torch.zeros_like(x)
        ranks, g = self.group_ranks(axis), self.group(axis)
        w = self._wire(x)
        recv = torch.zeros_like(w)
        ops = []
        if i + 1 < n:
            ops.append(dist.P2POp(dist.isend, w, ranks[i + 1], g))
        if i > 0:
            ops.append(dist.P2POp(dist.irecv, recv, ranks[i - 1], g))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return self._unwire(recv, x)

    def all_gather_object(self, obj, axes) -> list:
        """Picklable ``obj`` of every group member, in group order."""
        n = self.size(axes)
        if n == 1:
            return [obj]
        out = [None] * n
        dist.all_gather_object(out, obj, group=self.group(axes))
        return out

    def barrier(self, axes) -> None:
        if self.size(axes) == 1:
            return
        kw = ({"device_ids": [self.device.index]}
              if self.backend == "nccl" else {})
        dist.barrier(group=self.group(axes), **kw)


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is this package's :class:`Mesh`; a mesh of another
    kind (JAX's device mesh) is refused."""
    if not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"mesh= takes radar_tpu_torch.parallel.Mesh (SPMD ranks); a "
            f"{type(mesh).__name__} mesh is not ported")
    return mesh


def make_mesh(dp: int = 1, ch: int = 1, cpi: int = 1, *,
              device="cuda") -> Mesh:
    """This rank's (dp, ch, cpi) mesh over every rank of the initialised
    process group (one process without a group makes a mesh of one).
    ``device``: ``"cuda"`` (the default) puts rank r on card ``r %
    device_count``; ``"cpu"`` keeps the mesh on the CPU. Unlike JAX's,
    which may take the first dp*ch*cpi devices, the mesh spans every rank:
    a rank outside it would have no shard."""
    n = dp * ch * cpi
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = str(dist.get_backend())
    else:
        world, rank, backend = 1, 0, None
    if n != world:
        raise ValueError(f"a (dp={dp}, ch={ch}, cpi={cpi}) mesh needs {n} "
                         f"ranks, the process group has {world}")
    device = rank_device(device, rank)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend takes CUDA tensors only; use "
                         "gloo for a mesh on the CPU")
    shape = {AXIS_DP: dp, AXIS_CH: ch, AXIS_CPI: cpi}
    coords = dict(zip(AXES, (int(v) for v in
                             np.unravel_index(rank, (dp, ch, cpi)))))
    return Mesh(shape=shape, coords=coords, rank=rank, device=device,
                backend=backend,
                staging=backend == "gloo" and device.type == "cuda")
