"""PyTorch port: every tail of the frame processor, held against the JAX
package at small widths on the same noise.

- The rank-K stream (``kernel_maps``, ``beams_major_tail`` on ``"pallas"``
  and ``"pallas_prng"``, ``kernel_out_bf16``, ``means_impl="matmul"``):
  JAX's XLA chain on injected white noise, then JAX's own tail for the
  branch composed as ``radar_tpu/pipeline/frame.py:183-241`` does; the
  port's frame is handed the same noise as kernel planes.
- The reference stream (``tail_from_rdm``, the monopulse flags with
  ``keep_pair_mode``, ``means_impl="matmul"``; the native scan in
  test_torch_refframe.py): JAX's own ``make_frame_processor``, the port
  handed its draws.
- JAX's precedence warnings, one case each, and the Monte-Carlo trial
  function and ``run_streaming_mc`` under the tail flags.

Tolerances: equal final counts; range, velocity, angle and power rtol
1e-4 (f32 sums in another order); pair indices exactly; raw detection
counts equal where both tails see the same map."""

from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.cluster.stages import cluster_stage1 as j_stage1
from radar_tpu.cluster.stages import cluster_stage2 as j_stage2
from radar_tpu.config import params as jparams
from radar_tpu.measure.estimate import estimate_parameters as j_estimate
from radar_tpu.ops import cfar as jc
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.pulse_compression import make_matmul_plan as j_matmul_plan
from radar_tpu.pipeline.frame import make_frame_processor as j_make
from radar_tpu.pipeline.frame import measure_consts as j_consts
from radar_tpu.pipeline.lowrank import make_lowrank_stages as j_lowrank
from radar_tpu.pipeline.montecarlo import make_trial_fn as j_trial_fn
from radar_tpu.sim.echo import add_noise as j_add_noise
from radar_tpu.sim.scenario import TargetBatch as JTargets
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops.cfar_kernel import HALO
from radar_tpu_torch.ops.noise_rdm import planes_from_compact
from radar_tpu_torch.pipeline.frame import (make_frame_processor,
                                            make_frame_stages)
from radar_tpu_torch.pipeline.montecarlo import make_trial_fn
from radar_tpu_torch.pipeline.streaming import run_streaming_mc
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PERF = {**jparams.PERF_OVERRIDES, "matmul_precision": "f32"}
TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
FIELDS = ("range_m", "velocity_ms", "angle_deg", "power")
MATMUL = {"means_impl": "matmul"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores; these
    small-shape tests run torch on one thread, so the workers do not
    oversubscribe the cores (no hold here depends on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(over, cfar=None):
    out = []
    for mod in (jparams, tparams):
        cfg = mod.small_test_config().replace(**over)
        if cfar:
            cfg = cfg.replace(cfar=dataclasses.replace(cfg.cfar, **cfar))
        out.append(cfg)
    return out


def _rows(t):
    """Valid clustered targets as rows (range, velocity, angle, power
    [, pair])."""
    host = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    valid = host(t.valid)
    cols = [host(getattr(t, f))[valid] for f in FIELDS]
    if t.pair_idx is not None:
        cols.append(host(t.pair_idx)[valid])
    return np.stack(cols, 1).astype(np.float64)


def _assert_same(got, want_targets, want_raw=None):
    """Each row of ``got`` paired with the nearest of ``want`` in (range,
    velocity) (targets split by the clustering share a range to 1e-4)."""
    a, b = _rows(got.targets), _rows(want_targets)
    assert a.shape == b.shape and a.shape[0] >= 2, (a, b)
    dist = (np.abs(a[:, None, 0] - b[None, :, 0])
            + 10 * np.abs(a[:, None, 1] - b[None, :, 1]))
    pair = np.argmin(dist, axis=1)
    assert len(set(pair.tolist())) == len(pair)
    b = b[pair]
    np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=1e-4)
    np.testing.assert_array_equal(a[:, 4:], b[:, 4:])
    if want_raw is not None:
        assert int(got.num_raw_detections) == int(want_raw)


@pytest.fixture(scope="module")
def rank_k():
    """JAX's rank-K XLA chain map [V, G, B] on a white cube, the cube as
    the port's kernel planes, and the shared precompute."""
    jcfg, tcfg = _cfgs(PERF)
    jpre = j_precompute(jcfg)
    mtd = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num)
    jl = j_lowrank(jcfg, jpre, None, j_matmul_plan(jpre), mtd, jpre.mtd_win,
                   jnp.complex64)
    tpre = from_numpy(jpre._asdict())
    rplan = make_frame_processor(tcfg, tpre, device="cpu").stages.rplan
    num_b = jpre.dbf_w.shape[0]
    rng = np.random.default_rng(21)
    shape = (num_b, jcfg.sig.prt_num, rplan.s_compact)
    z = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
         * np.sqrt(0.5)).astype(np.complex64)                # [B, P, S_c]
    tb = JTargets.make(*TARGETS)
    rdm = jax.jit(lambda zz: jl.mix_add(jl.signal_rdm(tb),
                                        jl.mtd(jl.pc(zz))))(
        jnp.asarray(z.transpose(1, 2, 0)))
    return dict(jcfg=jcfg, tcfg=tcfg, jpre=jpre, tpre=tpre, rdm=rdm,
                planes=planes_from_compact(torch.from_numpy(z), rplan),
                mc=j_consts(jcfg, jpre, np.float32))


def _j_tail(jcfg, mc, rdm, branch, maps_qvg=None):
    """JAX's tail of ``branch`` on a [V, G, B] map, composed as its frame
    processor does (radar_tpu/pipeline/frame.py:183-241, 320-346) and
    jitted as there; the kernel-maps tail on ``maps_qvg`` where given (its
    kernel's maps)."""
    out = jax.jit(lambda r, m: _j_tail_body(jcfg, mc, r, branch, m))(
        rdm, maps_qvg)
    return out


def _j_tail_body(jcfg, mc, rdm, branch, maps_qvg):
    ip, cap = jcfg.interp, jcfg.cfar.max_detections
    est = dict(monopulse_complex=jcfg.monopulse_complex,
               monopulse_refined=jcfg.monopulse_refined)
    args = (ip.extra_dots, ip.r_interp_times, ip.v_interp_times)
    rdm_bm = jnp.transpose(rdm, (2, 0, 1))
    if branch == "kernel_maps":
        mag = jnp.abs(rdm_bm)
        maps = mag[:-1] + mag[1:] if maps_qvg is None else maps_qvg
        mask, _ = jc.goca_cfar_2d(maps, jcfg.cfar, layout="qvg")
        dets = jc.extract_detections(mask, maps, cap, layout="qvg",
                                     impl=jcfg.extract_impl)
        params = j_estimate(dets, maps, rdm_bm, mc, *args, layout="bvg",
                            maps_layout="qvg", **est)
    elif branch == "beams_major":
        maps = jc.pair_sum_maps_bm(rdm_bm)
        mask, _ = jc.goca_cfar_2d(maps, jcfg.cfar, layout="qgv")
        dets = jc.extract_detections(mask, maps, cap, layout="qgv",
                                     impl=jcfg.extract_impl)
        params = j_estimate(dets, maps, rdm_bm, mc, *args, layout="bvg",
                            **est)
    else:
        maps = jc.pair_sum_maps(rdm)
        mask, _ = jc.goca_cfar_2d(maps, jcfg.cfar)
        dets = jc.extract_detections(mask, maps, cap, impl=jcfg.extract_impl)
        params = j_estimate(dets, maps, rdm, mc, *args, **est)
    final = j_stage2(j_stage1(params, jcfg.cluster), jcfg.cluster)
    return final, dets.count


# (port and JAX flags, CFAR fields, JAX's tail, the map both see)
RANK_K = {
    "kernel_maps": ({"kernel_maps": True}, None, "kernel_maps", "jax"),
    "kernel_maps_matmul": ({"kernel_maps": True}, MATMUL, "kernel_maps",
                           "jax"),
    "beams_major_prng": ({"beams_major_tail": True}, None, "beams_major",
                         "jax"),
    "beams_major_pallas": ({"beams_major_tail": True,
                            "noise_rdm_impl": "pallas"}, None,
                           "beams_major", "jax"),
    "default_matmul": ({}, MATMUL, "vgq", "jax"),
    "kernel_out_bf16": ({"kernel_out_bf16": True}, None, "vgq", "port"),
    "kernel_maps_bf16_refined": ({"kernel_maps": True,
                                  "kernel_out_bf16": True,
                                  "monopulse_refined": True}, None,
                                 "kernel_maps", "port"),
}


@pytest.mark.parametrize("case", list(RANK_K))
def test_rank_k_tails_match_jax(rank_k, case):
    """The port's frame on the injected planes against JAX's tail on the
    same noise. Under kernel_out_bf16 JAX's tail runs on the port's own
    bf16 map and K1's maps of the unrounded one (the rounding and the
    maps themselves are held in test_torch_kernel_maps.py)."""
    over, cfar, branch, source = RANK_K[case]
    jcfg, tcfg = (c.replace(cfar=dataclasses.replace(c.cfar, **(cfar or {})))
                  for c in (rank_k["jcfg"].replace(**over),
                            rank_k["tcfg"].replace(**over)))
    process = make_frame_processor(tcfg, rank_k["tpre"], device="cpu")
    tb = TargetBatch.make(*TARGETS)
    got = process(0, tb, noise_planes=rank_k["planes"])
    rdm, maps = rank_k["rdm"], None
    if source == "port":
        rdm, maps_p = process.stages.noise_rdm_sig(
            0, tb, layout="vgb", planes=rank_k["planes"], emit_maps=True)
        num_v, num_g = rdm.shape[:2]
        rdm = jnp.asarray(rdm.numpy())
        maps = jnp.asarray(maps_p[:, :num_v, HALO:HALO + num_g].numpy())
    want, raw = _j_tail(jcfg, rank_k["mc"], rdm, branch, maps)
    _assert_same(got, want, raw if source == "port" else None)
    if source == "jax":
        # the two maps differ by f32 rounding: raw counts within a few
        # threshold ties
        assert abs(int(got.num_raw_detections) - int(raw)) <= 3


def test_kernel_maps_tail_runs_on_k1s_maps(rank_k):
    """The kernel-maps frame takes K1's maps and runs K2 on them (shift
    means) or the plain qvg CFAR (matmul means); the trials disregard
    it."""
    tcfg = rank_k["tcfg"].replace(kernel_maps=True)
    st = make_frame_stages(tcfg, rank_k["tpre"], device="cpu")
    assert st.tail == "kernel_maps"
    for over, tail in (({}, "qvg"), ({"extract_native_scan": True}, "vgq"),
                       ({"tail_from_rdm": True}, "vgq")):
        trial = make_frame_stages(tcfg.replace(**over), rank_k["tpre"],
                                  device="cpu", trials=True)
        assert trial.tail == tail
    assert make_frame_stages(
        tcfg.replace(kernel_maps=False, beams_major_tail=True),
        rank_k["tpre"], device="cpu").tail == "qgv"


# reference-stream cases: (flags, CFAR fields)
# (the native scan against JAX's frame: test_torch_refframe.py)
REFERENCE = {
    "monopulse_complex_pair_mode": ({"monopulse_complex": True}, None),
    "tail_from_rdm_monopulse_refined_pair_mode": (
        {"monopulse_refined": True, "tail_from_rdm": True}, None),
    "means_matmul": ({}, MATMUL),
}


@pytest.mark.parametrize("case", list(REFERENCE))
def test_reference_tails_match_jax_frame(case):
    over, cfar = REFERENCE[case]
    jcfg, tcfg = _cfgs(over, cfar)
    if "pair_mode" in case:
        jcfg, tcfg = (c.replace(cluster=dataclasses.replace(
            c.cluster, keep_pair_mode=True)) for c in (jcfg, tcfg))
    jpre = j_precompute(jcfg)
    key = jax.random.PRNGKey(4)
    want = j_make(jcfg, jpre)(key, JTargets.make(*TARGETS))
    p, s = jcfg.sig.prt_num, jpre.tx_pulse.shape[0]
    noise = np.array(j_add_noise(key, jnp.zeros(
        (p, s, jcfg.sig.channel_num), jnp.complex64)))
    got = make_frame_processor(tcfg, from_numpy(jpre._asdict()),
                               device="cpu")(0, TargetBatch.make(*TARGETS),
                                             noise=noise)
    _assert_same(got, want.targets, want.num_raw_detections)
    assert (got.targets.pair_idx is not None) == ("pair_mode" in case)


WARNINGS = {
    "kernel_maps_ignores_pallas_cfar": (
        {**PERF, "kernel_maps": True, "use_pallas_cfar": True},
        "cfg.use_pallas_cfar is ignored when cfg.kernel_maps"),
    "beams_major_ignores_native_scan": (
        {**PERF, "beams_major_tail": True, "extract_native_scan": True},
        "cfg.extract_native_scan is ignored when cfg.beams_major_tail"),
    "kernel_maps_over_beams_major": (
        {**PERF, "kernel_maps": True, "beams_major_tail": True},
        "cfg.kernel_maps takes precedence over cfg.beams_major_tail"),
    "pallas_cfar_over_tail_from_rdm": (
        {"use_pallas_cfar": True, "tail_from_rdm": True},
        "cfg.use_pallas_cfar takes precedence over cfg.tail_from_rdm"),
    "pallas_cfar_ignores_native_scan": (
        {"use_pallas_cfar": True, "extract_native_scan": True},
        "the qvg tail has no native-scan extraction"),
    "tail_from_rdm_needs_direct": (
        {"tail_from_rdm": True, "extract_impl": "rowfetch"},
        "cfg.tail_from_rdm is ignored unless extract_impl='direct'"),
    "kernel_maps_off_the_rank_k_stream": ({"kernel_maps": True}, None),
}


@pytest.fixture(scope="module")
def pre():
    jpre = j_precompute(jparams.small_test_config())
    return jpre, from_numpy(jpre._asdict())


def _warned(make):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        make()
    return sorted(str(w.message) for w in seen
                  if issubclass(w.category, UserWarning)
                  and str(w.message).startswith("cfg."))


@pytest.mark.parametrize("case", list(WARNINGS))
def test_precedence_warnings_match_jax(pre, case):
    over, text = WARNINGS[case]
    jcfg, tcfg = _cfgs(over)
    want = _warned(lambda: j_make(jcfg, pre[0]))
    got = _warned(lambda: make_frame_processor(tcfg, pre[1], device="cpu"))
    assert got == want
    assert (text is None) == (not got)
    assert text is None or any(text in w for w in got)


def test_trials_honour_the_tail_flags_on_jax_draws():
    """The trial function under tail_from_rdm, monopulse_refined and
    keep_pair_mode (kernel_maps set and disregarded, as JAX's
    make_trial_fn does), on the reference stream: JAX's trials on their
    own keys, the port's on those draws."""
    over = {"tail_from_rdm": True, "monopulse_refined": True,
            "kernel_maps": True}
    jcfg, tcfg = (c.replace(cluster=dataclasses.replace(
        c.cluster, keep_pair_mode=True)) for c in _cfgs(over))
    jpre = j_precompute(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    shape = (jcfg.sig.prt_num, jpre.tx_pulse.shape[0], jcfg.sig.channel_num)
    noise = [np.array(j_add_noise(k, jnp.zeros(shape, jnp.complex64)))
             for k in keys]
    truth = ([3000.0], [15.0], [10.0], [20.0])
    ja, jh = j_trial_fn(jcfg, jpre, jnp.complex64)(JTargets.make(*truth),
                                                   keys)
    ta, th = make_trial_fn(tcfg, from_numpy(jpre._asdict()), device="cpu")(
        TargetBatch.make(*truth), range(3), noise=noise)
    jh = np.asarray(jh)
    assert jh.all()
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4)


def test_streaming_mc_under_tail_flags():
    """After tests/test_streaming.py::test_streaming_mc_single_device, with
    tail_from_rdm and monopulse_refined on the rank-K stream (its xla
    route)."""
    cfg = tparams.small_test_config(channels=8, pulses=32).replace(
        **{**PERF, "noise_rdm_impl": "xla", "noise_dist": "normal"},
        tail_from_rdm=True, monopulse_refined=True)
    stats = run_streaming_mc(cfg, num_scenes=1, targets_per_scene=4,
                             trials_per_scene=2, seed=0,
                             snr_range=(12.0, 20.0), device="cpu")
    assert stats.total_targets == 4 * 2
    assert stats.detection_rate > 0.7, stats
    assert stats.range_rmse_m < 20.0
    assert stats.velocity_rmse_ms < 3.0
