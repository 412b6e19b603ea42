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

One push and one receive kernel serve both routes. ``exchange.
overlap_save_input(x)`` returns the input of the local overlap-save FFT,
``[rows, nfft]`` = [halo | own shard | zeros]: the push lands the halo in
columns ``[0, halo)`` of the receiver's slot, whose rows are ``nfft`` wide
(``halo + s_local`` unless given), and the receiver's fill kernel copies
its own shard beside it (the work of the ``cat`` and the FFT's zero
padding), so the halo is read where it landed. The returned tensor is a
read-only view of the receive slot, valid until the next call on the
exchange: a write into it would corrupt the slot's zero columns for every
later call, so the next call raises if one happened. ``exchange(x)``
returns the halo alone as a fresh ``[rows, halo]`` tensor, a copy of the
slot's first columns.

Setup is collective over the ring's axis group: every rank allocates its
receive slots and a control block with its own ``cudaMalloc`` (an IPC handle
names a whole allocation, and PyTorch's caching allocator sub-allocates, so
a tensor's pointer is not an allocation base), swaps the handles
(``all_gather_object``) and opens its right neighbour's. Every rank sends
one message and receives one; the message to the axis's first rank carries
no data (its halo is the causal edge's zeros). A one-rank ring pushes into
its own buffer. ``close()`` frees and unmaps, collectively.

Nothing on the call path waits for the card: the exchange runs on the
stream that was current when it was built (a call under another current
stream raises, since the caller's work on the slot would not be ordered
after the kernels), with the block counts and the ctypes entry points
taken then. A wait that times out on the card records the call in a status
word in mapped host memory; the wrapper reads it without a sync and raises
the ``RuntimeError`` that names the rank, the axis index and the sequence
number at the next call once the stream has passed the failed kernel, and
in any case at ``check()`` or ``close()``, which wait for the stream.

The plain versions are ``halo_right_plain`` (the ``batch_isend_irecv``
ring, staged through the host when the group is gloo and the tensors are on
a card) and ``overlap_save_input_plain`` (that ring, ``cat`` and zero
padding). An exchange takes them for CPU tensors only; a CUDA tensor
launches K6 or raises. Where ranks have their own cards, NCCL send/recv is
the library yardstick K6 is timed against; on one card, a ``copy_`` into
the peer buffer (``peer_slot_view``). Neither is the port.
"""

from __future__ import annotations

import ctypes

import torch

from .mesh import Mesh

k6_launch_count = 0          # K6 pushes (one per exchange on the card)
k6_fill_count = 0            # K6 fills (one per exchange on the card)

_SLOT_ALIGN = 256
_CTRL_BYTES = 256           # csrc/ring.cu: kCtrlBytes
_TIMEOUT_CODES = {1: "the right neighbour to free its receive slot",
                  2: "the left neighbour's halo"}


def halo_right_plain(x_local: torch.Tensor, mesh: Mesh, halo: int,
                     axis: str = "cpi") -> torch.Tensor:
    """Plain version of K6, on any device: the left neighbour's trailing
    ``halo`` columns of ``x_local [rows, s_local]`` (zeros on the axis's
    first rank)."""
    return mesh.shift_right(x_local[:, x_local.shape[1] - halo:], axis)


def overlap_save_input_plain(x_local: torch.Tensor, mesh: Mesh, halo: int,
                             nfft: int, axis: str = "cpi") -> torch.Tensor:
    """Plain version of K6's overlap-save route: ``[rows, nfft]`` = the left
    neighbour's halo, ``x_local``, then zeros."""
    x = torch.cat([halo_right_plain(x_local, mesh, halo, axis), x_local],
                  dim=-1)
    return torch.nn.functional.pad(x, (0, nfft - x.shape[-1]))


def flag_scopes(cards: list, index: int) -> tuple[int, int]:
    """(left, right) for rank ``index`` of a ring whose ranks sit on
    ``cards``: 1 where that neighbour's card is another (K6's flags with it
    then take the system's scope), 0 where they share one (the GPU's). The
    push pairs with the right neighbour, the fill with the left, so a
    rank's right scope is its right neighbour's left scope."""
    n = len(cards)
    return (int(cards[(index - 1) % n] != cards[index]),
            int(cards[(index + 1) % n] != cards[index]))


class _CudaBytes:
    """A device pointer as a byte array for ``torch.as_tensor``."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


def _view(ptr: int, rows: int, cols: int, dtype) -> torch.Tensor:
    """``[rows, cols]`` of ``dtype`` at device address ``ptr`` (no copy)."""
    esize = torch.empty((), dtype=dtype).element_size()
    raw = torch.as_tensor(_CudaBytes(ptr, rows * cols * esize))
    if raw.data_ptr() != ptr:
        raise RuntimeError("the view is not of the mapped buffer")
    return raw.view(dtype).view(rows, cols)


class HaloExchange:
    """``exchange(x_local [rows, s_local]) -> [rows, halo]``: the left
    neighbour's trailing ``halo`` columns along ``axis`` (zeros on its first
    rank); ``exchange.overlap_save_input(x_local) -> [rows, nfft]``. K6 for
    a CUDA tensor, the plain versions for a CPU tensor."""

    def __init__(self, mesh: Mesh, rows: int, s_local: int, halo: int,
                 axis: str = "cpi", dtype=torch.float32,
                 timeout_s: float = 10.0, nfft: int | None = None):
        if not 0 < halo <= s_local:
            raise ValueError(f"halo {halo} must be in (0, s_local="
                             f"{s_local}]")
        nfft = halo + s_local if nfft is None else nfft
        if nfft < halo + s_local:
            raise ValueError(f"nfft {nfft} must cover halo + s_local = "
                             f"{halo + s_local}")
        self.mesh, self.axis = mesh, axis
        self.rows, self.s_local, self.halo = rows, s_local, halo
        self.nfft = nfft
        self.dtype = dtype
        self.timeout_ns = int(timeout_s * 1e9)
        self.index, self.n = mesh.index(axis), mesh.size(axis)
        self._esize = torch.empty((), dtype=dtype).element_size()
        if self._esize % 4:
            # csrc/ring.cu copies rows in 4-byte words at least
            raise ValueError(f"the exchange takes a dtype of 4, 8 or 16 "
                             f"bytes, got {dtype}")
        self._slot = -(-rows * nfft * self._esize // _SLOT_ALIGN) \
            * _SLOT_ALIGN
        self._seq = 0
        self._pushed = False
        self._error = None
        self._lib = None
        if mesh.device.type == "cuda":
            self._open()

    def _open(self) -> None:
        from .. import _build

        lib = _build.load("ring")
        dev = self.mesh.device
        base, status = ctypes.c_void_p(), ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.k6_handle_bytes())
        _build.check(lib, lib.k6_alloc(
            dev.index, self._slot, ctypes.addressof(base),
            ctypes.addressof(handle), ctypes.addressof(status)), "k6_alloc")
        self._lib, self._base, self._status = lib, base.value, status.value
        peers = self.mesh.all_gather_object((handle.raw, dev.index),
                                            self.axis)
        right = peers[(self.index + 1) % self.n][0]
        if self.n == 1:
            self._peer = self._base
        else:
            right = ctypes.create_string_buffer(right)
            peer = ctypes.c_void_p()
            _build.check(lib, lib.k6_open(dev.index, ctypes.addressof(right),
                                          ctypes.addressof(peer)), "k6_open")
            self._peer = peer.value
        # taken once: the stream, the entry points, the block count, the
        # scopes of the flags, the receive slots as tensors
        self._stream_obj = torch.cuda.current_stream(dev)
        self._stream = self._stream_obj.cuda_stream
        self._k_push, self._k_fill = lib.k6_push, lib.k6_fill
        blocks = ctypes.c_int()
        _build.check(lib, lib.k6_blocks(dev.index, self.rows,
                                        ctypes.addressof(blocks)),
                     "k6_blocks")
        self._blocks = blocks.value
        self._sys_left, self._sys_right = flag_scopes(
            [card for _, card in peers], self.index)
        self._send = int((self.index + 1) % self.n != 0)
        self._code = ctypes.c_int.from_address(self._status)
        self._code_seq = ctypes.c_ulonglong.from_address(self._status + 8)
        self._slots = [_view(self._base + _CTRL_BYTES + p * self._slot,
                             self.rows, self.nfft, self.dtype)
                       for p in (0, 1)]
        self._versions = [t._version for t in self._slots]

    def _check(self, x: torch.Tensor) -> None:
        if tuple(x.shape) != (self.rows, self.s_local) or \
                x.dtype != self.dtype:
            raise ValueError(f"the exchange takes [{self.rows}, "
                             f"{self.s_local}] {self.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")

    def _check_card(self, x: torch.Tensor) -> None:
        """What a launch needs beyond ``_check``: the mesh's card, the
        exchange's stream, receive slots that nobody wrote into."""
        self._check(x)
        if self._lib is None or x.device != self.mesh.device:
            raise ValueError(f"K6 runs on the mesh's card "
                             f"{self.mesh.device}; got a tensor on "
                             f"{x.device}")
        if torch.cuda.current_stream(x.device).cuda_stream != self._stream:
            raise RuntimeError("K6 runs on the stream that was current when "
                               "the exchange was built; call it under that "
                               "stream")
        if [t._version for t in self._slots] != self._versions:
            raise RuntimeError("a view returned by overlap_save_input was "
                               "written in place; the receive slots are "
                               "read-only")

    def __call__(self, x_local: torch.Tensor) -> torch.Tensor:
        self._check(x_local)
        if not x_local.is_cuda:
            return halo_right_plain(x_local, self.mesh, self.halo, self.axis)
        return self.overlap_save_input(x_local)[:, :self.halo].clone()

    def overlap_save_input(self, x_local: torch.Tensor) -> torch.Tensor:
        """``[rows, nfft]``: the left neighbour's halo, ``x_local``, zeros
        (the input of the local overlap-save FFT). On the card a read-only
        view of this rank's receive slot, valid until the next call."""
        self._check(x_local)
        if not x_local.is_cuda:
            return overlap_save_input_plain(x_local, self.mesh, self.halo,
                                            self.nfft, self.axis)
        self.push(x_local)
        return self.fill(x_local)

    def _timeout(self, code: int, seq: int) -> RuntimeError:
        self._error = (f"K6 on rank {self.mesh.rank} ({self.axis} index "
                       f"{self.index} of {self.n}) timed out after "
                       f"{self.timeout_ns / 1e9} s waiting for "
                       f"{_TIMEOUT_CODES[code]} at sequence {seq}")
        return RuntimeError(self._error)

    def _raise_if_failed(self) -> None:
        """Raise the card's first timeout once it is recorded (no sync)."""
        if self._error is None and self._code.value:
            raise self._timeout(self._code.value, self._code_seq.value)

    def check(self) -> None:
        """Wait for the exchange's stream and raise if a wait of K6 timed
        out on the card (off the call path: the calls do not wait)."""
        if self._lib is not None:
            self._stream_obj.synchronize()
            self._raise_if_failed()

    def push(self, x_local: torch.Tensor) -> None:
        """Launch K6's push of ``x_local``'s trailing halo into the right
        neighbour's receive slot (asynchronous)."""
        global k6_launch_count
        from .. import _build

        self._check_card(x_local)
        self._raise_if_failed()
        if self._error is not None:
            raise RuntimeError(f"the halo exchange failed before: "
                               f"{self._error}")
        if self._pushed:
            raise RuntimeError("push() twice without a fill()")
        if x_local.stride(1) != 1:
            # freed tensors are reused only by later work on this stream,
            # so the copy may go out of scope before the kernel runs
            x_local = x_local.contiguous()
        self._seq += 1
        e = self._esize
        _build.check(self._lib, self._k_push(
            x_local.data_ptr() + (self.s_local - self.halo) * e,
            x_local.stride(0) * e, self.rows, self.halo * e, self._peer,
            self._slot, self.nfft * e, self._send, self._seq,
            self.timeout_ns, self._base, self._status, self._sys_right,
            self._blocks if self._send else 1, self._stream), "k6_push")
        self._pushed = True
        k6_launch_count += 1

    def fill(self, x_local: torch.Tensor) -> torch.Tensor:
        """Copy ``x_local`` (the tensor of the last push) beside the halo
        in this rank's receive slot; the slot ``[rows, nfft]`` (a read-only
        view, valid until the next call), ordered on the stream after the
        halo landed."""
        global k6_fill_count
        from .. import _build

        self._check_card(x_local)
        if not self._pushed:
            raise RuntimeError("fill() without push()")
        self._pushed = False
        if x_local.stride(1) != 1:
            x_local = x_local.contiguous()
        e = self._esize
        _build.check(self._lib, self._k_fill(
            self._base, self._slot, self.nfft * e, self.rows,
            x_local.data_ptr(), x_local.stride(0) * e, self.halo * e,
            self.s_local * e, self._seq, self.timeout_ns, self._status,
            self._sys_left, self._blocks, self._stream), "k6_fill")
        k6_fill_count += 1
        return self._slots[self._seq & 1]

    def peer_slot_view(self) -> torch.Tensor:
        """The halo columns of the right neighbour's first receive slot as
        a [rows, halo] tensor on the card that holds it (not a copy): what
        a one-call library copy would write into, to time it beside K6. The
        port never writes through it."""
        return _view(self._peer + _CTRL_BYTES, self.rows, self.nfft,
                     self.dtype)[:, :self.halo]

    def close(self) -> None:
        """Unmap the neighbour's buffer and free this rank's, after every
        rank of the ring is done (collective); then raise a timeout of the
        card that no call or ``check()`` has raised yet."""
        if self._lib is None:
            return
        lib, self._lib = self._lib, None
        from .. import _build

        torch.cuda.synchronize(self.mesh.device)
        self.mesh.barrier(self.axis)
        if self._peer != self._base:
            _build.check(lib, lib.k6_close(self._peer), "k6_close")
        self.mesh.barrier(self.axis)
        code, seq = self._code.value, self._code_seq.value
        self._slots = self._code = self._code_seq = None
        _build.check(lib, lib.k6_free(self._base, self._status), "k6_free")
        if self._error is None and code:
            raise self._timeout(code, seq)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def halo_right_permute(mesh: Mesh, rows: int, s_local: int, halo: int,
                       axis: str = "cpi", dtype=torch.float32,
                       timeout_s: float = 10.0,
                       nfft: int | None = None) -> HaloExchange:
    """Build the halo exchange of a [rows, s_local] local block along
    ``axis`` (collective over the axis group when the mesh is on a card).
    Any dtype of 4, 8 or 16 bytes; complex64 rides interleaved, with no
    split into planes. The receive slots are overlap-save FFT inputs of
    ``nfft`` (>= halo + s_local, by default equal) columns. Each wait of K6
    is bounded by ``timeout_s``."""
    return HaloExchange(mesh, rows, s_local, halo, axis, dtype, timeout_s,
                        nfft)
