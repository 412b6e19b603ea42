"""PyTorch port: the detection tails' operators — the CFAR in its three
layouts with shift and matmul means, the first-K extractions, the
estimation variants (maps-free gathers, the qgv maps, complex and refined
monopulse), the pair-mode clustering and the v5 single-stage clusterer —
held against the JAX package on the same numpy-made inputs.

Holds: masks, indices, amplitudes, counts and labels exactly (shift
means: the thresholds too, against JAX under jit, whose reciprocal
multiply the port takes), but values made by a complex ``abs`` rtol 1e-6
(torch's and XLA's differ in the last bit); matmul means: the noise
estimate rtol 1e-6 (the sums in another order) and mask differences only
in cells within 1e-5 of their threshold; estimates rtol 1e-5; the v5
clusterer rtol 1e-6."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.cluster.legacy import cluster_single_stage_v5 as j_v5
from radar_tpu.cluster.stages import cluster_stage1 as j_stage1
from radar_tpu.cluster.stages import cluster_stage2 as j_stage2
from radar_tpu.config import params as jparams
from radar_tpu.config.params import ClusterParams as JCluster
from radar_tpu.config.params import CfarParams as JCfar
from radar_tpu.measure.estimate import ParamDetections as JParams
from radar_tpu.measure.estimate import estimate_parameters as j_estimate
from radar_tpu.ops import cfar as jc
from radar_tpu.pipeline.frame import measure_consts as j_consts
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.cluster import cluster_single_stage_v5
from radar_tpu_torch.cluster.stages import cluster_stage1, cluster_stage2
from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.config.params import CfarParams, ClusterParams
from radar_tpu_torch.measure.estimate import (ParamDetections,
                                              estimate_parameters)
from radar_tpu_torch.ops import cfar as tc
from radar_tpu_torch.ops import cfar_kernel as ck
from radar_tpu_torch.pipeline.frame import measure_consts
from radar_tpu_torch.waveform.precompute import from_numpy

T = lambda x: torch.from_numpy(np.array(x))
SMALL = dict(ref_cells_v=3, guard_cells_v=4, ref_cells_r=5, guard_cells_r=10)
# [pairs, V, G] permuted to each layout
PERM = {"qvg": (0, 1, 2), "vgq": (1, 2, 0), "qgv": (0, 2, 1)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores; these
    small-shape tests run torch on one thread, so the workers do not
    oversubscribe the cores (no hold here depends on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maps_qvg(seed, shape=(4, 40, 300), hits=14):
    """Exponential clutter [pairs, V, G] with strong cells away from the
    borders."""
    rng = np.random.default_rng(seed)
    maps = rng.exponential(size=shape).astype(np.float32)
    for _ in range(hits):
        maps[rng.integers(0, shape[0]), rng.integers(8, shape[1] - 8),
             rng.integers(16, shape[2] - 16)] += 60.0
    return maps


# every layout with GOCA, every method on vgq (the combine does not see
# the layout), each with both means
CFAR_CASES = [(lay, "GOCA") for lay in ("vgq", "qvg", "qgv")] + [
    ("vgq", "SOCA"), ("vgq", "CA")]


@pytest.mark.parametrize("means", ["shift", "matmul"])
@pytest.mark.parametrize("layout,method", CFAR_CASES)
def test_goca_cfar_2d_layouts_and_means_match_jax(layout, method, means):
    maps = np.ascontiguousarray(_maps_qvg(1).transpose(PERM[layout]))
    tp = CfarParams(method=method, means_impl=means, **SMALL)
    jp = JCfar(method=method, means_impl=means, **SMALL)
    mask, thr = tc.goca_cfar_2d(T(maps), tp, layout)
    j_mask, j_thr = jax.jit(lambda m: jc.goca_cfar_2d(m, jp, layout))(
        jnp.asarray(maps))
    j_mask, j_thr = np.asarray(j_mask), np.asarray(j_thr)
    _, valid = tc.goca_noise_and_valid(T(maps), tp, layout)
    assert mask.sum() >= 10
    if means == "shift":
        np.testing.assert_array_equal(mask.numpy(), j_mask)
        np.testing.assert_array_equal(thr.numpy(), j_thr)
        return
    v = valid.expand_as(mask).numpy()
    np.testing.assert_allclose(thr.numpy()[v], j_thr[v], rtol=1e-6)
    d = mask.numpy() != j_mask
    assert np.all(np.abs(maps[d] - j_thr[d]) <= 1e-5 * np.abs(j_thr[d]))
    # and the matmul means are the shift means up to the order of the sums
    sh, _ = tc.goca_cfar_2d(T(maps), dataclasses.replace(
        tp, means_impl="shift"), layout)
    assert (sh != mask).sum() <= d.sum() + 2


def test_pair_sum_maps_bm_matches_jax():
    rng = np.random.default_rng(6)
    rdm = (rng.standard_normal((5, 20, 50))
           + 1j * rng.standard_normal((5, 20, 50))).astype(np.complex64)
    got = tc.pair_sum_maps_bm(T(rdm))
    want = np.asarray(jc.pair_sum_maps_bm(jnp.asarray(rdm)))
    assert got.shape == want.shape == (4, 50, 20) and got.is_contiguous()
    # torch's complex abs and XLA's differ in the last bit
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_k2_ignores_matmul_means():
    """K2's plain version takes shift means whatever ``means_impl`` says,
    as JAX's kernel does."""
    maps = ck.pad_maps_qvg(T(_maps_qvg(2)))
    shift = ck.goca_cfar_qvg(maps, CfarParams(**SMALL), 300, 40)
    matmul = ck.goca_cfar_qvg(maps, CfarParams(means_impl="matmul", **SMALL),
                              300, 40)
    assert torch.equal(shift[0], matmul[0]) and torch.equal(shift[1],
                                                            matmul[1])
    assert int(shift[0].sum()) >= 10


def _mask(seed, shape, density):
    return np.random.default_rng(seed).random(shape) < density


@pytest.mark.parametrize("capacity", [8, 512])
@pytest.mark.parametrize("row_width", [4096, 100])
def test_first_k_true_indices_matches_jax(capacity, row_width):
    flat = _mask(4, 30011, 0.01)
    got, ok = tc.first_k_true_indices(T(flat), capacity, row_width)
    want, j_ok = jc.first_k_true_indices(jnp.asarray(flat), capacity,
                                         row_width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    n = min(capacity, int(flat.sum()))
    np.testing.assert_array_equal(got.numpy()[:n], np.nonzero(flat)[0][:n])


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("capacity", [8, 512])
@pytest.mark.parametrize("layout", ["qgv", "qvg"])
def test_first_k_true_beams_major_matches_jax(layout, capacity, with_counts):
    """Under and over capacity, with the row counts or without; the qvg
    mask wider than the maps (K2's padded gate columns False)."""
    mask_qvg = np.zeros((4, 32, 512), bool)
    mask_qvg[:, :, :300] = _mask(3, (4, 32, 300), 0.004)
    mask = np.ascontiguousarray(mask_qvg.transpose(PERM[layout]))
    rc = mask_qvg.sum(axis=1).astype(np.int32) if with_counts else None
    got = tc.first_k_true_beams_major(
        T(mask), capacity, layout, None if rc is None else T(rc))
    want = jc.first_k_true_beams_major(
        jnp.asarray(mask), capacity, layout,
        None if rc is None else jnp.asarray(rc))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (int(mask.sum()) > capacity) == (capacity == 8)


@pytest.mark.parametrize("capacity", [8, 512])
@pytest.mark.parametrize("branch", ["qgv", "qvg_no_counts", "vgq_native",
                                    "vgq_rdm"])
def test_extract_detections_branches_match_jax(branch, capacity):
    """The qgv extraction, qvg without row counts (JAX's relayout branch
    and its direct one), the vgq native scan (JAX's own subset over
    capacity) and the vgq amplitudes from the RDM: slots, indices,
    amplitudes, validity and the true count."""
    rng = np.random.default_rng(8)
    num_q, num_v, num_g = 4, 32, 300
    mask = _mask(9, (num_q, num_v, num_g), 0.004)
    rdm = (rng.standard_normal((num_v, num_g, num_q + 1))
           + 1j * rng.standard_normal((num_v, num_g, num_q + 1))
           ).astype(np.complex64)
    mag = np.abs(rdm)
    maps_vgq = mag[:, :, :-1] + mag[:, :, 1:]
    kw, jkws = {}, [{"impl": "direct"}]
    if branch == "qgv":
        layout, m = "qgv", mask.transpose(0, 2, 1)
        maps = maps_vgq.transpose(2, 1, 0)
    elif branch == "qvg_no_counts":
        layout, m = "qvg", mask
        maps = maps_vgq.transpose(2, 0, 1)
        jkws = [{"impl": "direct"}, {"impl": "rowfetch"}]
    else:
        layout, m, maps = "vgq", mask.transpose(1, 2, 0), maps_vgq
        if branch == "vgq_native":
            kw = {"native_scan": True}
            jkws = [{"native_scan": True, "impl": "direct"},
                    {"native_scan": True, "impl": "rowfetch"}]
        else:
            kw = {"rdm": T(rdm)}
            jkws[0] = {"impl": "direct", "rdm": jnp.asarray(rdm)}
    m, maps = np.ascontiguousarray(m), np.ascontiguousarray(maps)
    got = tc.extract_detections(T(m), None if "rdm" in kw else T(maps),
                                capacity, layout=layout, **kw)
    for jkw in jkws:
        want = jc.extract_detections(
            jnp.asarray(m), None if "rdm" in jkw else jnp.asarray(maps),
            capacity, layout=layout, **jkw)
        for f in ("v_idx", "r_idx", "pair_idx", "valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)
        # from the RDM: torch's complex abs and XLA's differ in the last bit
        np.testing.assert_allclose(got.amp.numpy(), np.asarray(want.amp),
                                   rtol=1e-6 if "rdm" in kw else 0.0)
        assert int(got.count) == int(want.count) == int(mask.sum())


@pytest.fixture(scope="module")
def scene():
    """A random [V, G, B] RDM with bright cells, its pair maps, and JAX's
    detections on them."""
    cfg = jparams.small_test_config(max_detections=64)
    pre = j_precompute(cfg)
    rng = np.random.default_rng(5)
    num_v, num_g, num_b = cfg.sig.prt_num, pre.n_total_gate, 5
    rdm = ((rng.standard_normal((num_v, num_g, num_b))
            + 1j * rng.standard_normal((num_v, num_g, num_b)))
           ).astype(np.complex64)
    for v, g, b in ((12, 500, 1), (13, 500, 2), (20, 2000, 3), (12, 502, 1),
                    (22, 1200, 0)):
        rdm[v, g, b] += 80.0 * np.exp(1j * v)
        rdm[v + 1, g, b + 1] += 40.0 * np.exp(-1j * g)
    mag = np.abs(rdm)
    maps = np.ascontiguousarray(mag[:, :, :-1] + mag[:, :, 1:])   # vgq
    mask, _ = jc.goca_cfar_2d(jnp.asarray(maps), cfg.cfar)
    dets = jc.extract_detections(mask, jnp.asarray(maps),
                                 cfg.cfar.max_detections, impl="direct")
    tcfg = tparams.small_test_config(max_detections=64)
    tdets = tc.Detections(*[T(getattr(dets, f)).to(torch.int64)
                            if f.endswith("idx") else T(getattr(dets, f))
                            for f in tc.Detections._fields])
    return dict(cfg=cfg, tcfg=tcfg, rdm=rdm, maps=maps, dets=dets,
                tdets=tdets, mc=j_consts(cfg, pre, np.float32),
                tmc=measure_consts(tcfg, from_numpy(pre._asdict()),
                                   device="cpu"))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * max(float(np.max(np.abs(want))),
                                               1e-30))


# (rdm layout, maps layout or None for the maps-free gathers, monopulse
# complex, refined)
ESTIMATES = [("vgb", None, False, False), ("vgb", "qgv", False, False),
             ("bvg", None, False, False), ("vgb", "vgq", True, False),
             ("bvg", "qvg", True, False), ("vgb", "vgq", False, True),
             ("bvg", "qgv", False, True), ("vgb", "qvg", True, True),
             ("bvg", "qvg", True, True)]


@pytest.mark.parametrize("rdm_layout,maps_layout,cplx,refined", ESTIMATES)
def test_estimate_variants_match_jax(scene, rdm_layout, maps_layout, cplx,
                                     refined):
    """Every estimation variant on identical detections: ``maps_layout``
    None is the maps-free gather from the RDM on "vgb", and on "bvg" the
    default rule (qgv maps)."""
    rdm = scene["rdm"]
    maps = scene["maps"]                                        # [V, G, Q]
    if rdm_layout == "bvg":
        rdm = np.ascontiguousarray(rdm.transpose(2, 0, 1))
    free = maps_layout is None and rdm_layout == "vgb"
    want_layout = maps_layout or ("qgv" if rdm_layout == "bvg" else "vgq")
    if not free:
        maps = np.ascontiguousarray(maps.transpose(
            {"vgq": (0, 1, 2), "qvg": (2, 0, 1), "qgv": (2, 1, 0)}[
                want_layout]))
    ip = scene["tcfg"].interp
    args = (ip.extra_dots, ip.r_interp_times, ip.v_interp_times)
    kw = dict(layout=rdm_layout, maps_layout=maps_layout,
              monopulse_complex=cplx, monopulse_refined=refined)
    got = estimate_parameters(scene["tdets"], None if free else T(maps),
                              T(rdm), scene["tmc"], *args, **kw)
    want = j_estimate(scene["dets"], None if free else jnp.asarray(maps),
                      jnp.asarray(rdm), scene["mc"], *args, **kw)
    assert int(np.asarray(want.valid).sum()) >= 5
    for f in ("range_m", "velocity_ms", "angle_deg", "power"):
        _close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    if free:
        with pytest.raises(ValueError, match="vgb"):
            estimate_parameters(scene["tdets"], None,
                                T(rdm.transpose(2, 0, 1)), scene["tmc"],
                                *args, layout="bvg")


def _pair_mode_detections(seed, n=64, live=48):
    """Clusters of detections whose members share a few pair indices; the
    first cluster's most frequent indices tie (3 and 1 alike often, 7
    once), so its mode is 1."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(1000, 9000, 8)
    idx = rng.integers(0, 8, n)
    idx[:4] = 0
    r = centers[idx] + rng.normal(0, 3, n)
    v = 5.0 * idx + rng.normal(0, 0.05, n)
    a = 2.0 * idx + rng.normal(0, 0.2, n)
    pair = (idx + rng.integers(0, 2, n)) % 12
    first = np.nonzero((idx == 0) & (np.arange(n) < live))[0]
    pair[first] = np.where(np.arange(first.size) % 2, 1, 3)
    if first.size % 2:
        pair[first[-1]] = 7
    power = rng.uniform(1, 50, n)
    valid = np.arange(n) < live
    f32 = lambda x: np.where(valid, x, 0).astype(np.float32)
    return (f32(r), f32(v), f32(a), f32(power), pair.astype(np.int32),
            valid, first)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keep_pair_mode_matches_jax(seed):
    """The modal pair index (stage 1, MATLAB mode's smallest-value
    tie-break) and the winner's (stage 2): validity and pair indices
    exactly, the merged fields rtol 1e-5."""
    r, v, a, power, pair, valid, first = _pair_mode_detections(seed)
    jp, tp = JCluster(keep_pair_mode=True), ClusterParams(keep_pair_mode=True)
    jd = JParams(*(jnp.asarray(x) for x in (r, v, a, power, pair, valid)))
    td = ParamDetections(T(r), T(v), T(a), T(power),
                         T(pair).to(torch.int64), T(valid))
    j1, t1 = j_stage1(jd, jp), cluster_stage1(td, tp)
    j2, t2 = j_stage2(j1, jp), cluster_stage2(t1, tp)
    for j, t in ((j1, t1), (j2, t2)):
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        np.testing.assert_array_equal(t.pair_idx.numpy(),
                                      np.asarray(j.pair_idx))
        for f in ("range_m", "velocity_ms", "angle_deg", "power"):
            _close(getattr(t, f), getattr(j, f))
    assert int(t1.valid.sum()) >= 4
    # the first cluster's representative is its smallest member: the tie
    # breaks to 1
    assert bool(t1.valid[first[0]]) and int(t1.pair_idx[first[0]]) == 1
    assert cluster_stage1(td, ClusterParams()).pair_idx is None


def test_cluster_single_stage_v5_matches_jax():
    """After tests/test_legacy_cluster.py::test_v5_clustering_matches_oracle:
    the same hits through both packages."""
    rng = np.random.default_rng(11)
    n, cap = 25, 40
    vi, ri, pw = np.zeros(cap), np.zeros(cap), np.zeros(cap)
    vi[:n] = rng.integers(0, 32, n)
    ri[:n] = rng.integers(0, 200, n)
    pw[:n] = rng.uniform(1.0, 50.0, n)
    valid = np.arange(cap) < n
    range_axis = np.linspace(0.0, 1200.0, 200)
    velocity_axis = np.linspace(-16.0, 16.0, 32)
    want = j_v5(jnp.asarray(vi), jnp.asarray(ri), jnp.asarray(pw),
                jnp.asarray(valid), range_axis, velocity_axis)
    got = cluster_single_stage_v5(T(vi), T(ri), T(pw), T(valid), range_axis,
                                  velocity_axis)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.valid.sum()) >= 5
    for f in ("range_m", "velocity_ms", "angle_deg", "power"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-9)
