"""PyTorch port: 2D GOCA-CFAR, kernel K2's plain version and the first-K
extraction, held bit-exactly against the JAX package (masks, row counts,
indices, amplitudes and counts are compared with equality)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config.params import CfarParams as JCfar
from radar_tpu.ops.cfar import extract_detections as j_extract
from radar_tpu.ops.cfar import goca_cfar_2d as j_cfar
from radar_tpu.ops.cfar import pair_sum_maps as j_pair_sum_maps
from radar_tpu.ops.pallas_kernels import goca_cfar_qvg_pallas
from radar_tpu.ops.pallas_kernels import pad_maps_qvg as j_pad

from radar_tpu_torch.config.params import (CfarParams, full_config,
                                           small_test_config)
from radar_tpu_torch.ops import cfar_kernel as ck
from radar_tpu_torch.ops.cfar import (extract_detections, goca_cfar_2d,
                                      pair_sum_maps)

SMALL = dict(ref_cells_v=3, guard_cells_v=4, ref_cells_r=5, guard_cells_r=10)


def _maps(seed, shape, hits=12, axes=(1, 2)):
    """Exponential clutter with strong cells away from the borders."""
    rng = np.random.default_rng(seed)
    maps = rng.exponential(size=shape).astype(np.float32)
    for _ in range(hits):
        idx = [rng.integers(0, n) for n in shape]
        idx[axes[0]] = rng.integers(8, shape[axes[0]] - 8)
        idx[axes[1]] = rng.integers(16, shape[axes[1]] - 16)
        maps[tuple(idx)] += 60.0
    return maps



@pytest.mark.parametrize("layout", ["vgq", "qvg"])
@pytest.mark.parametrize("method", ["GOCA", "SOCA", "CA"])
def test_goca_cfar_2d_matches_jax(layout, method):
    shape = (40, 300, 4) if layout == "vgq" else (4, 40, 300)
    axes = (0, 1) if layout == "vgq" else (1, 2)
    maps = _maps(1, shape, axes=axes)
    mask, thr = goca_cfar_2d(torch.from_numpy(maps),
                             CfarParams(method=method, **SMALL), layout)
    mask_j, thr_j = j_cfar(jnp.asarray(maps), JCfar(method=method, **SMALL),
                           layout)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert mask.sum() >= 10
    # the port multiplies by the f32 reciprocal of ref where eager JAX
    # divides: thresholds agree to the last bit or one ulp
    np.testing.assert_allclose(thr.numpy(), np.asarray(thr_j), rtol=2.5e-7)


@pytest.mark.parametrize("method", ["GOCA", "SOCA", "CA"])
def test_k2_plain_matches_jax_pallas_kernel(method):
    """K2's plain version vs the JAX Pallas kernel (interpret mode): mask
    and per-(pair, gate) row counts identical; padded columns False."""
    num_q, num_v, num_g = 3, 48, 700          # 700: not a GATE_TILE multiple
    maps = _maps(2, (num_q, num_v, num_g))
    tp = ck.pad_maps_qvg(torch.from_numpy(maps))
    jp = j_pad(jnp.asarray(maps))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    mask, rc = ck.goca_cfar_qvg(tp, CfarParams(method=method, **SMALL),
                                num_g, num_v)
    mask_j, rc_j = goca_cfar_qvg_pallas(jp, JCfar(method=method, **SMALL),
                                        num_g, num_v, interpret=True)
    assert mask.shape == mask_j.shape and rc.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(rc.numpy(), np.asarray(rc_j))
    assert mask[:, :, num_g:].sum() == 0 and mask.sum() >= 10


def test_pair_sum_maps_match_jax():
    rng = np.random.default_rng(6)
    rdm = (rng.standard_normal((20, 50, 5))
           + 1j * rng.standard_normal((20, 50, 5))).astype(np.complex64)
    got = pair_sum_maps(torch.from_numpy(rdm))
    want = np.asarray(j_pair_sum_maps(jnp.asarray(rdm)))
    assert got.shape == want.shape == (20, 50, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_k2_refuses_what_jax_refuses():
    maps = ck.pad_maps_qvg(torch.zeros(2, 40, 300))
    with pytest.raises(ValueError, match="HALO"):
        ck.goca_cfar_qvg(maps, CfarParams(ref_cells_r=100, guard_cells_r=40),
                         300, 40)
    with pytest.raises(ValueError, match="method"):
        ck.goca_cfar_qvg(maps, CfarParams(method="GO"), 300, 40)
    # JAX's kernel never reads means_impl (shift means): K2 ignores it
    maps = ck.pad_maps_qvg(torch.from_numpy(_maps(2, (2, 40, 300))))
    want = ck.goca_cfar_qvg(maps, CfarParams(**SMALL), 300, 40)
    got = ck.goca_cfar_qvg(maps, CfarParams(means_impl="matmul", **SMALL),
                           300, 40)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[0].sum()) > 0


@pytest.mark.parametrize("capacity", [8, 64, 512])
@pytest.mark.parametrize("with_counts", [True, False])
def test_extract_detections_matches_jax(capacity, with_counts):
    """First-K extraction on a padded qvg mask, with the kernel's row
    counts or without: same slots, indices, amplitudes, validity and the
    true count (above capacity too)."""
    rng = np.random.default_rng(3)
    num_q, num_v, num_g, g_out = 4, 32, 300, 512
    mask = np.zeros((num_q, num_v, g_out), bool)
    mask[:, :, :num_g] = rng.random((num_q, num_v, num_g)) < 0.004
    maps = rng.exponential(size=(num_q, num_v, num_g)).astype(np.float32)
    rc = mask.sum(axis=1).astype(np.int32)
    got = extract_detections(torch.from_numpy(mask), torch.from_numpy(maps),
                             capacity, layout="qvg",
                             row_counts=torch.from_numpy(rc)
                             if with_counts else None)
    want = j_extract(jnp.asarray(mask), jnp.asarray(maps), capacity,
                     layout="qvg", impl="direct",
                     row_counts=jnp.asarray(rc) if with_counts else None)
    for f in ("v_idx", "r_idx", "pair_idx", "amp", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert int(got.count) == int(want.count) == int(mask.sum())
    # order: (pair, range, velocity)-major, as the reference's find
    n = min(capacity, int(mask.sum()))
    q, v, g = np.nonzero(mask)
    order = np.lexsort((v, g, q))[:n]
    np.testing.assert_array_equal(got.pair_idx.numpy()[:n], q[order])
    np.testing.assert_array_equal(got.r_idx.numpy()[:n], g[order])
    np.testing.assert_array_equal(got.v_idx.numpy()[:n], v[order])


@pytest.mark.parametrize("window", [
    "full", "small", "generic", "wide_range", "wide_doppler", "widest"])
def test_k2_instance_and_tma_boxes(window):
    """Which K2 instantiation a window selects (the full/perf config's
    10/5/10/5 and small_test_config's 10/5/4/3 are compiled in, any other
    window up to HALO is the generic one) and its TMA boxes: 16-byte inner
    dimension, at most 256 a dimension, the boxes covering the row strip
    (128 + 2 hrp gates, hrp the range half-window rounded up to 4) and the
    column strip (tv + 2 hv rows), in the shared memory a block has."""
    params = {"full": full_config().cfar,
              "small": small_test_config().cfar,
              "generic": CfarParams(guard_cells_r=2, ref_cells_r=3,
                                    guard_cells_v=1, ref_cells_v=2),
              "wide_range": CfarParams(guard_cells_r=60, ref_cells_r=68),
              "wide_doppler": CfarParams(guard_cells_v=100, ref_cells_v=28),
              "widest": CfarParams(guard_cells_r=100, ref_cells_r=28,
                                   guard_cells_v=100, ref_cells_v=28)}[window]
    geo = ck.k2_geometry(params)
    want = {"full": 0, "small": 1}.get(window, len(ck.K2_WINDOWS))
    assert geo.instance == want
    hr = params.guard_cells_r + params.ref_cells_r
    hv = params.guard_cells_v + params.ref_cells_v
    hrp = -(-hr // 4) * 4
    assert geo.tv == (32 if want < len(ck.K2_WINDOWS) else 16)
    assert geo.rw * 4 % 16 == 0 and geo.rw <= ck.TMA_BOX
    assert geo.cbh <= ck.TMA_BOX
    assert geo.rnc * geo.rw >= ck.K2_GATES + 2 * hrp
    assert geo.rnc == 1 or geo.rw == ck.K2_GATES
    assert geo.cnr * geo.cbh >= geo.tv + 2 * hv
    if want < len(ck.K2_WINDOWS):
        assert (geo.rnc, geo.cnr) == (1, 1)
        assert geo.rw == ck.K2_GATES + 2 * hrp
    smem = 4 * (-(-geo.rnc * geo.tv * geo.rw // 32) * 32
                + geo.cnr * geo.cbh * ck.K2_GATES)
    assert smem + 128 <= 232448 - 2048


@pytest.mark.parametrize("window", [
    "full", "small", "generic", "wide_range", "wide_doppler", "widest"])
def test_k3_instance_and_tma_boxes(window):
    """Which K3 instantiation a window selects (the same compiled-in windows
    as K2's; any other window up to HALO is the generic one), its tile (32
    rows x 128 gates compiled in, 16 x 32 generic), its TMA boxes (16-byte
    inner dimension, at most 256 a dimension, starting on 128-byte
    boundaries; a compiled-in window's one box the tile with its whole halo,
    the generic row and column strips covering tile gates + 2 hrp and tile
    rows + 2 hv), its groups of pairs, and three beam slots in the shared
    memory a block has."""
    params = {"full": full_config().cfar,
              "small": small_test_config().cfar,
              "generic": CfarParams(guard_cells_r=2, ref_cells_r=3,
                                    guard_cells_v=1, ref_cells_v=2),
              "wide_range": CfarParams(guard_cells_r=60, ref_cells_r=68),
              "wide_doppler": CfarParams(guard_cells_v=100, ref_cells_v=28),
              "widest": CfarParams(guard_cells_r=100, ref_cells_r=28,
                                   guard_cells_v=100, ref_cells_v=28)}[window]
    geo = ck.k3_geometry(params, 13)
    want = {"full": 0, "small": 1}.get(window, len(ck.K2_WINDOWS))
    assert geo.instance == want == ck.k2_geometry(params).instance
    hr = params.guard_cells_r + params.ref_cells_r
    hv = params.guard_cells_v + params.ref_cells_v
    hrp = -(-hr // 4) * 4
    fixed = want < len(ck.K2_WINDOWS)
    assert (geo.tv, geo.gt) == ((32, 128) if fixed else (16, 32))
    assert geo.rw % 4 == 0 and 4 <= geo.rw <= ck.TMA_BOX
    assert geo.gt % 4 == 0 and geo.cbh <= ck.TMA_BOX
    assert geo.rnc * geo.rw >= geo.gt + 2 * hrp
    assert geo.cnr * geo.cbh >= geo.tv + 2 * hv
    assert geo.tv * geo.rw % 32 == 0 and geo.cbh * geo.gt % 32 == 0
    if fixed:
        # one box a beam: the tile with its whole halo
        assert (geo.rnc, geo.cnr, geo.groups) == (1, 1, ck.K3_GROUPS)
        assert geo.rw == geo.gt + 2 * hrp and geo.cbh == geo.tv + 2 * hv
    else:
        assert geo.groups == 1
    assert ck.k3_smem_bytes(geo) <= ck.MAX_SMEM


@pytest.mark.parametrize("num_b", [2, 3, 4, 13])
@pytest.mark.parametrize("window", ["full", "small", "generic"])
def test_k3_groups_take_every_pair_once(window, num_b):
    """K3's groups of pairs at any beam count >= 2: never more groups than
    pairs (k3_cfar refuses that), and the kernel's split (per = ceil(pairs
    / groups) pairs a group, group z from z * per) covers every pair once
    with no group empty."""
    params = {"full": full_config().cfar,
              "small": small_test_config().cfar,
              "generic": CfarParams(guard_cells_r=2, ref_cells_r=3,
                                    guard_cells_v=1, ref_cells_v=2)}[window]
    geo = ck.k3_geometry(params, num_b)
    pairs = num_b - 1
    assert 1 <= geo.groups <= pairs
    per = (num_b - 2 + geo.groups) // geo.groups
    covered = [q for z in range(geo.groups)
               for q in range(z * per, min(pairs, z * per + per))]
    assert covered == list(range(pairs))
    assert all(z * per < pairs for z in range(geo.groups))
