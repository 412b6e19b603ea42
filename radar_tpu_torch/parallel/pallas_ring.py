"""Ring halo exchange: kernel K6 — port of
``radar_tpu/parallel/pallas_ring.py`` (``halo_right_permute``, the
``pl.pallas_call`` at :80).

Range-sharded overlap-save pulse compression (``parallel/collectives.py::
pulse_compress_range_sharded``) needs, on every fast-time shard, the last
``len(h) - 1`` samples of its left neighbour (the causal history of the
segmented PC, fun_process_single_frame.m:114-120). The TPU kernel pushes
each shard's trailing ``halo`` columns into the right neighbour's buffer
with one remote DMA per chip; K6 (``csrc/ring.cu``) does the same with peer
stores into a receive buffer the neighbour allocated and exported by CUDA
IPC. It works the same for ranks that share one card (processes, one
context each) and for ranks on separate cards of a host (NVLink).

Setup is collective over the ring's axis group: every rank allocates its
receive slots and a control block with its own ``cudaMalloc`` (an IPC handle
names a whole allocation, and PyTorch's caching allocator sub-allocates, so
a tensor's pointer is not an allocation base), swaps the handles
(``all_gather_object``) and opens its right neighbour's. Traffic is uniform
(every rank sends one message and receives one); the first rank's received
halo is replaced by zeros, the causal edge. A one-rank ring pushes into its
own buffer. ``close()`` frees and unmaps, collectively.

The plain version is the ``"ppermute"`` transport: ``batch_isend_irecv`` of
``x[:, -halo:]`` to the right neighbour within the axis group, staged
through the host when the group is gloo and the tensors are on a card.
An exchange takes it for CPU tensors only; a CUDA tensor launches K6 or
raises. Where ranks have their own cards, NCCL send/recv is the library
yardstick K6 is timed against; on one card, a ``copy_`` into the peer
buffer (``peer_slot_view``). Neither is the port.
"""

from __future__ import annotations

import ctypes

import torch

from .mesh import Mesh

k6_launch_count = 0          # K6 launches (one per exchange on the card)

_SLOT_ALIGN = 256
_CTRL_BYTES = 256           # csrc/ring.cu: kCtrlBytes


def halo_right_plain(x_local: torch.Tensor, mesh: Mesh, halo: int,
                     axis: str = "cpi") -> torch.Tensor:
    """Plain version of K6, on any device: the left neighbour's trailing
    ``halo`` columns of ``x_local [rows, s_local]`` (zeros on the axis's
    first rank)."""
    return mesh.shift_right(x_local[:, x_local.shape[1] - halo:], axis)


class _CudaBytes:
    """A device pointer as a byte array for ``torch.as_tensor``."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


class HaloExchange:
    """``exchange(x_local [rows, s_local]) -> [rows, halo]``: the left
    neighbour's trailing ``halo`` columns along ``axis`` (zeros on its first
    rank). K6 for a CUDA tensor (``push`` then ``pull``, the host waiting
    for the halo), the plain version for a CPU tensor."""

    def __init__(self, mesh: Mesh, rows: int, s_local: int, halo: int,
                 axis: str = "cpi", dtype=torch.float32,
                 timeout_s: float = 10.0):
        if not 0 < halo <= s_local:
            raise ValueError(f"halo {halo} must be in (0, s_local="
                             f"{s_local}]")
        self.mesh, self.axis = mesh, axis
        self.rows, self.s_local, self.halo = rows, s_local, halo
        self.dtype = dtype
        self.timeout_ns = int(timeout_s * 1e9)
        self.index, self.n = mesh.index(axis), mesh.size(axis)
        self._esize = torch.empty((), dtype=dtype).element_size()
        if self._esize % 4:
            # csrc/ring.cu copies rows in 4-byte words at least
            raise ValueError(f"the exchange takes a dtype of 4, 8 or 16 "
                             f"bytes, got {dtype}")
        self.nbytes = rows * halo * self._esize
        self._slot = -(-self.nbytes // _SLOT_ALIGN) * _SLOT_ALIGN
        self._seq = 0
        self._pushed = False
        self._error = None
        self._lib = None
        if mesh.device.type == "cuda":
            self._open()

    def _open(self) -> None:
        from .. import _build

        lib = _build.load("ring")
        dev = self.mesh.device.index
        base = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.k6_handle_bytes())
        _build.check(lib, lib.k6_alloc(dev, self._slot,
                                       ctypes.addressof(base),
                                       ctypes.addressof(handle)), "k6_alloc")
        self._lib, self._base = lib, base.value
        handles = self.mesh.all_gather_object(handle.raw, self.axis)
        if self.n == 1:
            self._peer = self._base
        else:
            right = ctypes.create_string_buffer(
                handles[(self.index + 1) % self.n])
            peer = ctypes.c_void_p()
            _build.check(lib, lib.k6_open(dev, ctypes.addressof(right),
                                          ctypes.addressof(peer)), "k6_open")
            self._peer = peer.value

    def _check(self, x: torch.Tensor) -> None:
        if tuple(x.shape) != (self.rows, self.s_local) or \
                x.dtype != self.dtype:
            raise ValueError(f"the exchange takes [{self.rows}, "
                             f"{self.s_local}] {self.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")

    def __call__(self, x_local: torch.Tensor) -> torch.Tensor:
        self._check(x_local)
        if not x_local.is_cuda:
            return halo_right_plain(x_local, self.mesh, self.halo, self.axis)
        self.push(x_local)
        return self.pull()

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.mesh.device).cuda_stream

    def push(self, x_local: torch.Tensor) -> None:
        """Launch K6's push of ``x_local``'s trailing halo into the right
        neighbour's receive slot (asynchronous)."""
        global k6_launch_count
        from .. import _build

        self._check(x_local)
        if self._lib is None or x_local.device != self.mesh.device:
            raise ValueError(f"K6 runs on the mesh's card "
                             f"{self.mesh.device}; got a tensor on "
                             f"{x_local.device}")
        if self._error is not None:
            raise RuntimeError(f"the halo exchange failed before: "
                               f"{self._error}")
        if self._pushed:
            raise RuntimeError("push() twice without pull()")
        if x_local.stride(1) != 1:
            x_local = x_local.contiguous()
        self._src = x_local                  # alive until the pull
        self._seq += 1
        e = self._esize
        code = self._lib.k6_push(
            x_local.data_ptr() + (self.s_local - self.halo) * e,
            x_local.stride(0) * e, self.rows, self.halo * e, self._peer,
            self._slot, self._seq, self.timeout_ns, self._base,
            self._stream())
        _build.check(self._lib, code, "k6_push")
        self._pushed = True
        k6_launch_count += 1

    def pull(self) -> torch.Tensor:
        """Wait for the left neighbour's halo of the last push and return
        it as a new tensor (zeros on the axis's first rank); raises, naming
        the rank and the call, when a wait timed out."""
        from .. import _build

        if not self._pushed:
            raise RuntimeError("pull() without push()")
        self._pushed = False
        out = torch.empty((self.rows, self.halo), dtype=self.dtype,
                          device=self.mesh.device)
        stream = self._stream()
        _build.check(self._lib, self._lib.k6_pull(
            self._base, self._slot, out.data_ptr(), self.nbytes, self._seq,
            int(self.index == 0), self.timeout_ns, stream), "k6_pull")
        status, seq = ctypes.c_int(), ctypes.c_ulonglong()
        _build.check(self._lib, self._lib.k6_status(
            self._base, stream, ctypes.addressof(status),
            ctypes.addressof(seq)), "k6_status")
        self._src = None
        if status.value:
            what = ("the right neighbour to free its receive slot"
                    if status.value == 1 else "the left neighbour's halo")
            self._error = (f"K6 on rank {self.mesh.rank} ({self.axis} index "
                           f"{self.index} of {self.n}) timed out after "
                           f"{self.timeout_ns / 1e9} s waiting for {what} "
                           f"at sequence {seq.value}")
            raise RuntimeError(self._error)
        return out

    def peer_slot_view(self) -> torch.Tensor:
        """The right neighbour's first receive slot as a [rows, halo]
        tensor on the card that holds it (not a copy): what a one-call
        library copy would write into, to time it beside K6. The port never
        writes through it."""
        ptr = self._peer + _CTRL_BYTES
        raw = torch.as_tensor(_CudaBytes(ptr, self.nbytes))
        if raw.data_ptr() != ptr:
            raise RuntimeError("the peer slot view is not the mapped buffer")
        return raw.view(self.dtype).view(self.rows, self.halo)

    def close(self) -> None:
        """Unmap the neighbour's buffer and free this rank's, after every
        rank of the ring is done (collective)."""
        if self._lib is None:
            return
        lib, self._lib = self._lib, None
        from .. import _build

        torch.cuda.synchronize(self.mesh.device)
        self.mesh.barrier(self.axis)
        if self._peer != self._base:
            _build.check(lib, lib.k6_close(self._peer), "k6_close")
        self.mesh.barrier(self.axis)
        _build.check(lib, lib.k6_free(self._base), "k6_free")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def halo_right_permute(mesh: Mesh, rows: int, s_local: int, halo: int,
                       axis: str = "cpi", dtype=torch.float32,
                       timeout_s: float = 10.0) -> HaloExchange:
    """Build the halo exchange of a [rows, s_local] local block along
    ``axis`` (collective over the axis group when the mesh is on a card).
    Any dtype of 4, 8 or 16 bytes; complex64 rides interleaved, with no
    split into planes. Each wait of K6 is bounded by ``timeout_s``."""
    return HaloExchange(mesh, rows, s_local, halo, axis, dtype, timeout_s)
