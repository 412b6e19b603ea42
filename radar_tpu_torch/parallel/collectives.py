"""The radar pipeline's communication patterns as explicit collectives —
port of ``radar_tpu/parallel/collectives.py``.

Where JAX returns a jitted ``shard_map`` over global arrays, the port
returns a function that every rank calls on its local shard (SPMD), with
JAX's layouts and axis names; ``shard_along`` cuts a global array into this
rank's block and ``gather_along`` puts a result together again:

  - ``dbf_channel_sharded``: local partial DBF + all-reduce over the
    channel axis (the beamformer's partial-sum reduction);
  - ``pulse_compress_range_sharded``: range-sharded overlap-save fast
    convolution; each shard needs the last ``len(h) - 1`` samples of its
    left neighbour, carried by the plain ``batch_isend_irecv`` ring
    (``"ppermute"``) or by kernel K6 (``"rdma"``, ``pallas_ring.py``),
    which stores it straight into the local FFT's input;
  - ``mtd_cpi_sharded``: window, all-to-all pulses -> gates, slow-time FFT
    + fftshift, all-to-all back (the distributed-FFT transpose);
  - ``covariance_snapshot_sharded``: snapshot-sharded X X^H / K by
    all-reduce (MUSIC at scale).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dbf import dbf_weights_effective
from .mesh import Mesh
from .pallas_ring import halo_right_permute, halo_right_plain


def shard_along(x, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of the global array ``x`` along ``dim``, sharded
    over ``axes`` in group order, on the mesh's device."""
    x = torch.as_tensor(x)
    n, i = mesh.size(axes), mesh.index(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible by "
                         f"the {axes} size {n}")
    per = x.shape[dim] // n
    return x.narrow(dim, i * per, per).contiguous().to(mesh.device)


def gather_along(y: torch.Tensor, mesh: Mesh, axes, dim: int
                 ) -> torch.Tensor:
    """The global array of the blocks ``y`` of the group over ``axes``."""
    return mesh.all_gather(y, axes, dim=dim)


def pulses_to_gates(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Reshard [P/n, G, ...] pulse blocks into [P, ceil(G/n), ...] gate
    blocks (gates zero-padded to a multiple of n) by one all-to-all."""
    n = mesh.size(axes)
    if n == 1:
        return x
    p, g, rest = x.shape[0], x.shape[1], tuple(x.shape[2:])
    gl = -(-g // n)
    if gl * n != g:
        x = torch.cat([x, x.new_zeros((p, gl * n - g) + rest)], dim=1)
    blocks = x.reshape((p, n, gl) + rest).transpose(0, 1)
    got = mesh.all_to_all(blocks.contiguous(), axes)      # [n, p, gl, ...]
    return got.reshape((n * p, gl) + rest)


def gates_to_pulses(y: torch.Tensor, mesh: Mesh, axes,
                    num_gates: int) -> torch.Tensor:
    """The inverse of ``pulses_to_gates``: [P, ceil(G/n), ...] -> [P/n, G,
    ...]."""
    n = mesh.size(axes)
    if n == 1:
        return y
    p, gl, rest = y.shape[0] // n, y.shape[1], tuple(y.shape[2:])
    got = mesh.all_to_all(y.reshape((n, p, gl) + rest).contiguous(), axes)
    return got.transpose(0, 1).reshape((p, n * gl) + rest)[:, :num_gates]


def dbf_channel_sharded(mesh: Mesh, axis: str = "ch", variant: str = "v8"):
    """``f(iq_local [P, S, C/n], w_local [B, C/n]) -> [P, S, B]`` with the
    channel axis sharded over ``axis``: each rank contracts its channel
    block, and the partial beams are summed over the group (cf.
    fun_process_single_frame.m:95's full product). ``v7_7`` flips the local
    block, as JAX's does."""

    def f(iq_local: torch.Tensor, w_local: torch.Tensor) -> torch.Tensor:
        m = dbf_weights_effective(torch.as_tensor(
            w_local, device=iq_local.device).to(iq_local.dtype), variant)
        return mesh.all_reduce(torch.einsum("psc,bc->psb", iq_local, m),
                               axis)

    return f


def _local_overlap_save(seg: torch.Tensor, hf: torch.Tensor, lh: int,
                        halo_left: torch.Tensor, nfft: int) -> torch.Tensor:
    """Fast convolution of [rows, L_local] given the left neighbour's halo
    [rows, lh - 1] and the filter's ``nfft``-point spectrum; the causal
    output aligned to this shard's samples."""
    x = torch.cat([halo_left, seg], dim=-1)
    y = torch.fft.ifft(torch.fft.fft(x, n=nfft, dim=-1) * hf, n=nfft, dim=-1)
    # output col k of x is col k - (lh - 1) of the shard
    return y[..., lh - 1:lh - 1 + seg.shape[-1]]


class RangeShardedPC:
    """``pc(x_local [rows, S/n]) -> [rows, S/n]``: see
    :func:`pulse_compress_range_sharded`. ``close()`` releases K6's buffers
    (collective)."""

    def __init__(self, mesh: Mesh, filter_taps, nfft: int, axis: str,
                 halo_impl: str):
        if halo_impl not in ("ppermute", "rdma"):
            raise ValueError(f"halo_impl={halo_impl!r}: not one of "
                             "('ppermute', 'rdma')")
        self.mesh, self.nfft, self.axis = mesh, nfft, axis
        self.halo_impl = halo_impl
        self.h = np.ascontiguousarray(filter_taps)
        self.lh = self.h.shape[0]
        self._hf = {}
        self.exchange = None

    def _exchange_for(self, x: torch.Tensor):
        """K6's exchange for ``x``'s shape and dtype (built on first use,
        collectively), with overlap-save receive slots of ``nfft``."""
        ex = self.exchange
        if ex is None or (ex.rows, ex.s_local, ex.dtype) != (
                x.shape[0], x.shape[1], x.dtype):
            self.close()
            self.exchange = halo_right_permute(
                self.mesh, x.shape[0], x.shape[1], self.lh - 1, self.axis,
                x.dtype, nfft=self.nfft)
        return self.exchange

    def __call__(self, x_local: torch.Tensor) -> torch.Tensor:
        key = (x_local.dtype, x_local.device)
        if key not in self._hf:
            h = torch.as_tensor(self.h).to(x_local.device, x_local.dtype)
            self._hf[key] = torch.fft.fft(h, n=self.nfft)
        hf, lh = self._hf[key], self.lh
        if self.halo_impl == "ppermute" or lh == 1:
            halo = (halo_right_plain(x_local, self.mesh, lh - 1, self.axis)
                    if lh > 1 else x_local[:, :0])
            return _local_overlap_save(x_local, hf, lh, halo, self.nfft)
        # K6 lands the halo in the FFT's input ([halo | shard | zeros])
        x = self._exchange_for(x_local).overlap_save_input(x_local)
        y = torch.fft.ifft(torch.fft.fft(x, dim=-1) * hf, dim=-1)
        return y[..., lh - 1:lh - 1 + x_local.shape[-1]]

    def close(self) -> None:
        if self.exchange is not None:
            self.exchange.close()
            self.exchange = None


def pulse_compress_range_sharded(mesh: Mesh, filter_taps, nfft: int,
                                 axis: str = "cpi",
                                 halo_impl: str = "ppermute"
                                 ) -> RangeShardedPC:
    """``f(x_local [rows, S/n]) -> [rows, S/n]``: the causal linear
    convolution with ``filter_taps`` along fast time, sharded over ``axis``
    (the overlap-save halo exchange of SURVEY.md section 5.7a; shard 0's
    halo is zeros, the causal edge). ``nfft`` must cover ``S/n + len(h) -
    1`` samples.

    ``halo_impl``: ``"ppermute"`` (the plain ``batch_isend_irecv`` ring,
    ``cat`` and the FFT's zero padding) or ``"rdma"`` (kernel K6 for
    tensors on a card, which lands the halo and the shard in the FFT's
    input; its plain version, the same ring, ``cat`` and padding, for CPU
    tensors). Both give bit-identical output."""
    return RangeShardedPC(mesh, filter_taps, nfft, axis, halo_impl)


def mtd_cpi_sharded(mesh: Mesh, mtd_win, axis: str = "cpi"):
    """``f(pc_local [P/n, G, B]) -> rdm_local [P/n, G, B]`` with the pulse
    axis sharded over ``axis``: window locally, all-to-all pulses -> gates
    so each rank transforms full slow-time columns of its gate block, FFT +
    fftshift, all-to-all back. G must be a multiple of n."""
    win = np.asarray(mtd_win)

    def f(pc: torch.Tensor) -> torch.Tensor:
        n, i, p_loc = mesh.size(axis), mesh.index(axis), pc.shape[0]
        if pc.shape[1] % n:
            raise ValueError(f"{pc.shape[1]} gates not divisible by the "
                             f"{axis} size {n}")
        w = torch.as_tensor(win[i * p_loc:(i + 1) * p_loc],
                            device=pc.device).to(pc.real.dtype)
        x = pulses_to_gates(pc * w[:, None, None], mesh, axis)
        y = torch.fft.fftshift(torch.fft.fft(x, dim=0), dim=0)
        return gates_to_pulses(y, mesh, axis, pc.shape[1])

    return f


def covariance_snapshot_sharded(mesh: Mesh, axis: str = "cpi"):
    """``f(x_local [C, K/n]) -> [C, C]``: X X^H / K with the snapshot axis
    sharded (local outer products + all-reduce; the MUSIC covariance's
    cross-shard reduction, SURVEY.md section 5.7c)."""

    def f(x: torch.Tensor) -> torch.Tensor:
        k_total = x.shape[1] * mesh.size(axis)
        return mesh.all_reduce(x @ x.T.conj(), axis) / k_total

    return f
