"""PyTorch port: parameter estimation and the two clustering stages, held
against the JAX package on identical detections. Estimated fields rtol
1e-5; component labels exactly."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.cluster.connected import connected_labels as j_labels
from radar_tpu.cluster.connected import gate_adjacency as j_adjacency
from radar_tpu.cluster.stages import cluster_stage1 as j_stage1
from radar_tpu.cluster.stages import cluster_stage2 as j_stage2
from radar_tpu.config import params as jparams
from radar_tpu.measure.estimate import ParamDetections as JParams
from radar_tpu.measure.estimate import estimate_parameters as j_estimate
from radar_tpu.ops.cfar import extract_detections as j_extract
from radar_tpu.ops.cfar import goca_cfar_2d as j_cfar
from radar_tpu.pipeline.frame import measure_consts as j_consts
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.cluster.connected import (connected_labels,
                                               gate_adjacency)
from radar_tpu_torch.cluster.stages import cluster_stage1, cluster_stage2
from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.measure.estimate import ParamDetections, \
    estimate_parameters
from radar_tpu_torch.ops.cfar import Detections
from radar_tpu_torch.pipeline.frame import measure_consts
from radar_tpu_torch.waveform.precompute import from_numpy

T = lambda x: torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * max(float(np.max(np.abs(want))),
                                               1e-30))


@pytest.fixture(scope="module")
def scene():
    """A random [V, G, B] RDM with bright cells, its qvg maps, and JAX's
    detections and estimates on them."""
    cfg = jparams.small_test_config(max_detections=64)
    pre = j_precompute(cfg)
    rng = np.random.default_rng(5)
    num_v, num_g, num_b = cfg.sig.prt_num, pre.n_total_gate, 5
    rdm = ((rng.standard_normal((num_v, num_g, num_b))
            + 1j * rng.standard_normal((num_v, num_g, num_b)))
           ).astype(np.complex64)
    for v, g, b in ((12, 500, 1), (13, 500, 2), (20, 2000, 3), (12, 502, 1)):
        rdm[v, g, b] += 80.0 * np.exp(1j * v)
        rdm[v + 1, g, b] += 40.0
    mag = np.abs(rdm.transpose(2, 0, 1))
    maps = np.ascontiguousarray(mag[:-1] + mag[1:])          # [Q, V, G]
    mask, _ = j_cfar(jnp.asarray(maps), cfg.cfar, layout="qvg")
    dets = j_extract(mask, jnp.asarray(maps), cfg.cfar.max_detections,
                     layout="qvg", impl="direct")
    mc = j_consts(cfg, pre, np.float32)
    ip = cfg.interp
    est = j_estimate(dets, jnp.asarray(maps), jnp.asarray(rdm), mc,
                     ip.extra_dots, ip.r_interp_times, ip.v_interp_times,
                     maps_layout="qvg")
    tdets = Detections(*[T(getattr(dets, f)).to(torch.int64)
                         if f.endswith("idx") else T(getattr(dets, f))
                         for f in Detections._fields])
    tcfg = tparams.small_test_config(max_detections=64)
    tmc = measure_consts(tcfg, from_numpy(pre._asdict()), device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, rdm=rdm, maps=maps, dets=tdets,
                est=est, tmc=tmc, n=int(dets.count))


@pytest.mark.parametrize("rdm_layout", ["vgb", "bvg"])
def test_estimate_parameters_matches_jax(scene, rdm_layout):
    ip = scene["tcfg"].interp
    rdm = scene["rdm"] if rdm_layout == "vgb" else \
        np.ascontiguousarray(scene["rdm"].transpose(2, 0, 1))
    got = estimate_parameters(scene["dets"], T(scene["maps"]), T(rdm),
                              scene["tmc"], ip.extra_dots, ip.r_interp_times,
                              ip.v_interp_times, layout=rdm_layout,
                              maps_layout="qvg")
    assert scene["n"] >= 4
    for f in ("range_m", "velocity_ms", "angle_deg", "power"):
        _close(getattr(got, f), getattr(scene["est"], f))
    np.testing.assert_array_equal(got.valid.numpy(),
                                  np.asarray(scene["est"].valid))


@pytest.mark.parametrize("vel_gate", [None, 1.0])
def test_cluster_stages_match_jax(scene, vel_gate):
    jc = scene["cfg"].cluster.__class__(stage2_vel_gate=vel_gate)
    tc = scene["tcfg"].cluster.__class__(stage2_vel_gate=vel_gate)
    est = scene["est"]
    tparams_ = ParamDetections(*[T(getattr(est, f)) for f in
                                 JParams._fields])
    s1j, s1t = j_stage1(est, jc), cluster_stage1(tparams_, tc)
    s2j, s2t = j_stage2(s1j, jc), cluster_stage2(s1t, tc)
    for j, t in ((s1j, s1t), (s2j, s2t)):
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        for f in ("range_m", "velocity_ms", "angle_deg", "power"):
            _close(getattr(t, f), getattr(j, f))
    assert int(s2t.count) == int(s2j.count) >= 1


def test_connected_labels_permuted_chains_equal_jax():
    """The 7-node chain in slot order [1,4,2,3,6,5,0] and 20 permuted
    128-slot chains collapse to one component each, labelled as JAX."""
    rng = np.random.default_rng(5)
    orders = [np.array([1, 4, 2, 3, 6, 5, 0])] + [rng.permutation(128)
                                                 for _ in range(20)]
    for order in orders:
        n = len(order)
        x = np.empty(n)
        x[order] = np.arange(n, dtype=float)
        ok = np.ones(n, bool)
        got = connected_labels(gate_adjacency([(T(x), 1.0)], T(ok)), T(ok))
        want = j_labels(j_adjacency([(jnp.asarray(x), 1.0)],
                                    jnp.asarray(ok)), jnp.asarray(ok))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert len(np.unique(got.numpy())) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_labels_random_graphs_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = 96
    x, y = rng.random(n) * 20, rng.random(n) * 20
    ok = rng.random(n) < 0.8
    fields = lambda f: [(f(x), 1.5), (f(y), 1.5)]
    got = connected_labels(gate_adjacency(fields(T), T(ok)), T(ok))
    want = j_labels(j_adjacency(fields(jnp.asarray), jnp.asarray(ok)),
                    jnp.asarray(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
