"""2D GOCA-CFAR kernels K2 and K3 — port of
``radar_tpu/ops/pallas_kernels.py:39-129, 132-318``.

- K2 (``goca_cfar_qvg_pallas``, ``pad_maps_qvg``): CFAR over padded qvg
  pair-sum maps, each block staged by TMA, the windows of ``K2_WINDOWS``
  compiled in (``k2_geometry``: which instantiation and which TMA boxes a
  window takes). ``goca_cfar_qvg`` runs ``csrc/cfar.cu`` for CUDA tensors
  and the plain PyTorch version ``goca_cfar_qvg_plain``
  (``ops/cfar.py::goca_cfar_2d`` on the un-padded maps) only for CPU
  tensors. Both give the mask bit for bit and the per-(pair, gate) hit
  counts that ``extract_detections`` consumes.
- K3 (``goca_cfar_2d_pallas``): the adjacent-beam pair sum fused with the
  same CFAR, on beams-major magnitudes [B, V, G], a block walking every
  beam of its tile through a ring of TMA-staged beam slots
  (``k3_geometry``: instantiation, tile and TMA boxes). ``goca_cfar_2d_fused``
  runs ``csrc/cfar.cu`` for CUDA tensors and the plain version
  ``goca_cfar_2d_fused_plain`` (``goca_cfar_2d`` of the pair sums) only
  for CPU tensors; mask and threshold agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config.params import CfarParams
from .cfar import goca_cfar_2d

HALO = 128          # >= ref+guard of any accepted window
GATE_TILE = 512     # output gate columns are padded to a multiple of this
_METHODS = {"GOCA": 0, "SOCA": 1, "CA": 2}

launch_count = 0    # K2 launches
k3_launch_count = 0  # K3 launches

# K2's compile-time windows (guard_r, ref_r, guard_v, ref_v): the full and
# perf configs', and small_test_config's
K2_WINDOWS = ((10, 5, 10, 5), (10, 5, 4, 3))
K2_GATES = 128       # gates per K2 block
TMA_BOX = 256        # TMA's most elements a box dimension
K3_SLOTS = 3         # beam slots of a K3 block's ring
K3_GROUPS = 2        # groups of pairs a compiled-in window's tile walks
MAX_SMEM = 232448 - 2048   # dynamic shared memory a block may take


class K2Geometry(NamedTuple):
    instance: int    # index into K2_WINDOWS, or len(K2_WINDOWS): generic
    tv: int          # Doppler rows per block
    rw: int          # row-strip box width (gates), rnc boxes side by side
    rnc: int
    cbh: int         # column-strip box height (rows), cnr boxes stacked
    cnr: int


def k2_geometry(params: CfarParams) -> K2Geometry:
    """K2's template instantiation for ``params``' window and its TMA boxes:
    a block stages the row strip (tv rows x 128 + 2 hrp gates, hrp the range
    half-window rounded up to 4 so the lanes' 16-byte loads stay aligned)
    and the column strip (tv + 2 hv rows x 128 gates). An instantiated
    window takes 32 rows and one box each; the generic one 16 rows and, where
    a strip is wider than TMA's 256, boxes of 128 gates or of half its
    rows."""
    win = (params.guard_cells_r, params.ref_cells_r, params.guard_cells_v,
           params.ref_cells_v)
    hr = params.guard_cells_r + params.ref_cells_r
    hv = params.guard_cells_v + params.ref_cells_v
    width = K2_GATES + 2 * (-(-hr // 4) * 4)
    if win in K2_WINDOWS:
        return K2Geometry(K2_WINDOWS.index(win), 32, width, 1, 32 + 2 * hv, 1)
    tv = 16
    rw, rnc = ((width, 1) if width <= TMA_BOX
               else (K2_GATES, -(-width // K2_GATES)))
    rows = tv + 2 * hv
    cbh, cnr = (rows, 1) if rows <= TMA_BOX else (-(-rows // 2), 2)
    return K2Geometry(len(K2_WINDOWS), tv, rw, rnc, cbh, cnr)


class K3Geometry(NamedTuple):
    instance: int    # index into K2_WINDOWS, or len(K2_WINDOWS): generic
    tv: int          # Doppler rows per block
    gt: int          # gates per block
    rw: int          # compiled in: the box's width (gt + 2 hrp); generic:
    rnc: int         # the row strip's box width, rnc boxes side by side
    cbh: int         # compiled in: the box's height (tv + 2 hv); generic:
    cnr: int         # the column strip's box height, cnr boxes stacked
    groups: int      # groups of pairs a tile's beams are walked in


def k3_geometry(params: CfarParams, num_b: int) -> K3Geometry:
    """K3's template instantiation for ``params``' window, its tile, its TMA
    boxes and how many groups of pairs a tile's blocks walk for ``num_b``
    beams. A compiled-in window takes a 32 x 128 tile and stages each beam
    as one box, the tile with its whole halo ([32 + 2 hv] x [128 + 2 hrp],
    hrp the range half-window rounded up to 4); its pairs are walked in 2
    groups (at 13 beams 594 blocks, 4.5 waves of the 132 SMs, where one
    group's 297 blocks left the third of 3 waves a quarter full), or in one
    where there is only one pair. The generic one takes a 16 x 32 tile
    (three slots of the widest window fit a block), a row strip (16 x 32 + 2
    hrp) and a column strip (16 + 2 hv x 32), each split evenly into boxes
    of at most TMA's 256, and one group."""
    win = (params.guard_cells_r, params.ref_cells_r, params.guard_cells_v,
           params.ref_cells_v)
    hr = params.guard_cells_r + params.ref_cells_r
    hv = params.guard_cells_v + params.ref_cells_v
    hrp = -(-hr // 4) * 4
    if win in K2_WINDOWS:
        return K3Geometry(K2_WINDOWS.index(win), 32, 128, 128 + 2 * hrp, 1,
                          32 + 2 * hv, 1, min(K3_GROUPS, num_b - 1))
    tv, gt = 16, 32
    width, rows = gt + 2 * hrp, tv + 2 * hv
    rnc, cnr = -(-width // TMA_BOX), -(-rows // TMA_BOX)
    return K3Geometry(len(K2_WINDOWS), tv, gt, -(-width // (4 * rnc)) * 4,
                      rnc, -(-rows // cnr), cnr, 1)


def k3_smem_bytes(geo: K3Geometry) -> int:
    """Dynamic shared memory of a K3 block: ``K3_SLOTS`` slots (a
    compiled-in window's box, or the generic row strip padded to 128 bytes
    and the column strip), and 128 bytes of alignment."""
    if geo.instance < len(K2_WINDOWS):
        slot = geo.cbh * geo.rw
    else:
        slot = (-(-geo.rnc * geo.tv * geo.rw // 32) * 32
                + geo.cnr * geo.cbh * geo.gt)
    return 4 * K3_SLOTS * -(-slot // 32) * 32 + 128


def _check_params(params: CfarParams, means: bool = True) -> None:
    """Refuse what the padded layout cannot hold exactly: a window wider
    than HALO would read past the zero halo, and an unknown method must
    not silently become another one. ``means``: refuse
    ``means_impl="matmul"`` (K3; K2 ignores it, as JAX's kernel does)."""
    border_r = params.ref_cells_r + params.guard_cells_r
    border_v = params.ref_cells_v + params.guard_cells_v
    if border_r > HALO or border_v > HALO:
        raise ValueError(
            f"CFAR window ref+guard (r={border_r}, v={border_v}) exceeds "
            f"HALO={HALO}; use ops/cfar.py::goca_cfar_2d for windows this "
            "wide")
    if params.method not in _METHODS:
        raise ValueError(f"unknown CFAR method: {params.method}")
    if means and params.means_impl != "shift":
        raise NotImplementedError(
            f"cfg.cfar.means_impl={params.means_impl!r}: K3 computes shift "
            "means; the frame runs the plain CFAR for matmul means")


def pad_maps_qvg(maps_qvg: torch.Tensor) -> torch.Tensor:
    """Zero-pad [pairs, V, G] maps: HALO columns on the left, fill to
    HALO + ceil(G/GATE_TILE)*GATE_TILE + HALO, Doppler rows to a multiple
    of 8 (the JAX layout, kept so the two are interchangeable)."""
    num_v, num_g = maps_qvg.shape[1:]
    g_pad = -(-num_g // GATE_TILE) * GATE_TILE + 2 * HALO
    v_pad = -(-num_v // 8) * 8
    return torch.nn.functional.pad(
        maps_qvg, (HALO, g_pad - num_g - HALO, 0, v_pad - num_v))


def goca_cfar_qvg_plain(maps_padded: torch.Tensor, params: CfarParams,
                        num_gates: int, num_v: int):
    """Plain PyTorch version of K2: (mask bool [pairs, V, G_out], rc int32
    [pairs, G_out]) with G_out = n_tiles * GATE_TILE; padded columns are
    False. Shift means whatever ``means_impl`` says, as K2. Runs on any
    device (the card uses it to check K2)."""
    _check_params(params, means=False)
    num_q, _, g_pad = maps_padded.shape
    maps = maps_padded[:, :num_v, HALO:HALO + num_gates]
    m, _ = goca_cfar_2d(maps, dataclasses.replace(params, means_impl="shift"),
                        layout="qvg")
    mask = torch.zeros((num_q, num_v, g_pad - 2 * HALO), dtype=torch.bool,
                       device=maps_padded.device)
    mask[:, :, :num_gates] = m
    return mask, mask.sum(dim=1, dtype=torch.int32)


_args: dict = {}   # k2_cfar's and k3_cfar's window and geometry arguments


def _window_args(params: CfarParams, num_b: int | None = None) -> tuple:
    """k2_cfar's (no ``num_b``) or k3_cfar's (for ``num_b`` beams)
    arguments from the window to the geometry, kept per ``params`` and
    ``num_b``."""
    key = (params, num_b)
    if key not in _args:
        geo = (k2_geometry(params) if num_b is None
               else k3_geometry(params, num_b))
        _args[key] = (
            params.guard_cells_r, params.ref_cells_r, params.guard_cells_v,
            params.ref_cells_v, float(np.float32(1.0 / params.ref_cells_r)),
            float(np.float32(1.0 / params.ref_cells_v)),
            float(np.float32(params.threshold_factor)),
            _METHODS[params.method], *geo)
    return _args[key]


def _goca_cfar_qvg_cuda(maps_padded, params, num_gates, num_v):
    global launch_count
    from .. import _build

    num_q, v_pad, g_pad = maps_padded.shape
    if maps_padded.dtype != torch.float32 or not maps_padded.is_contiguous():
        raise ValueError("K2 takes contiguous f32 maps")
    if (g_pad - 2 * HALO) % GATE_TILE or v_pad % 8 or v_pad < num_v \
            or num_gates > g_pad - 2 * HALO:
        raise ValueError("pad the maps with pad_maps_qvg()")
    lib = _build.load("cfar")
    dev = maps_padded.device
    out_cols = g_pad - 2 * HALO
    mask = torch.empty((num_q, num_v, out_cols), dtype=torch.bool, device=dev)
    rc = torch.empty((num_q, out_cols), dtype=torch.int32, device=dev)
    code = lib.k2_cfar(
        maps_padded.data_ptr(), num_q, v_pad, g_pad, num_v, num_gates, HALO,
        *_window_args(params), mask.data_ptr(), rc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "k2_cfar")
    launch_count += 1
    return mask, rc


def goca_cfar_qvg(maps_padded: torch.Tensor, params: CfarParams,
                  num_gates: int, num_v: int):
    """2D CFAR over ``pad_maps_qvg`` maps: K2 for a CUDA tensor (or it
    raises), the plain version for a CPU tensor. Shift means: like JAX's
    kernel, K2 ignores ``means_impl``."""
    _check_params(params, means=False)
    if maps_padded.is_cuda:
        return _goca_cfar_qvg_cuda(maps_padded, params, num_gates, num_v)
    return goca_cfar_qvg_plain(maps_padded, params, num_gates, num_v)


def goca_cfar_2d_fused_plain(mag: torch.Tensor, params: CfarParams):
    """Plain PyTorch version of K3: ``goca_cfar_2d(pair_sum_maps(.))`` of
    beams-major magnitudes ``mag`` [B, V, G] -> (mask bool, threshold) as
    [V, G, B-1] views of [B-1, V, G] tensors. Runs on any device (the card
    uses it to check K3)."""
    _check_params(params)
    maps = mag[:-1] + mag[1:]                                   # [Q, V, G]
    mask, thr = goca_cfar_2d(maps, params, layout="qvg")
    return mask.permute(1, 2, 0), thr.permute(1, 2, 0)


def _goca_cfar_2d_fused_cuda(mag: torch.Tensor, params: CfarParams):
    global k3_launch_count
    from .. import _build

    if mag.dtype != torch.float32 or not mag.is_contiguous() \
            or mag.dim() != 3 or mag.shape[0] < 2:
        raise ValueError("K3 takes contiguous f32 magnitudes [B >= 2, V, G]")
    lib = _build.load("cfar")
    num_b, num_v, num_g = mag.shape
    if num_g % 4 or mag.data_ptr() % 16:
        # TMA reads rows of 16-byte multiples from a 16-byte aligned base
        mag = (torch.nn.functional.pad(mag, (0, -num_g % 4)) if num_g % 4
               else mag.clone())
    mask = torch.empty((num_b - 1, num_v, num_g), dtype=torch.bool,
                       device=mag.device)
    thr = torch.empty((num_b - 1, num_v, num_g), dtype=torch.float32,
                      device=mag.device)
    code = lib.k3_cfar(
        mag.data_ptr(), num_b, num_v, num_g, mag.shape[2],
        *_window_args(params, num_b), mask.data_ptr(), thr.data_ptr(),
        torch.cuda.current_stream(mag.device).cuda_stream)
    _build.check(lib, code, "k3_cfar")
    k3_launch_count += 1
    return mask.permute(1, 2, 0), thr.permute(1, 2, 0)


def goca_cfar_2d_fused(mag: torch.Tensor, params: CfarParams):
    """Pair sum |RDM_b| + |RDM_b+1| and 2D CFAR of beams-major magnitudes
    ``mag`` [B, V, G]: (mask bool [V, G, B-1], threshold [V, G, B-1]), the
    outputs of ``goca_cfar_2d(pair_sum_maps(rdm))``, as views of
    [B-1, V, G] tensors. K3 for a CUDA tensor (or it raises), the plain
    version for a CPU tensor."""
    _check_params(params)
    if mag.is_cuda:
        return _goca_cfar_2d_fused_cuda(mag, params)
    return goca_cfar_2d_fused_plain(mag, params)
