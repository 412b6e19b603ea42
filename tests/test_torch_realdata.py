"""PyTorch port: the real-data path (``ops/ddc.py``, ``ops/cfar1d.py``,
``ops/mtd.py::zero_velocity_suppress``, ``pipeline/stages.py``) held
against the JAX package on the same numpy-made inputs, at the reference's
gated width (3404 gates, 13 beams) and example 04's 64 pulses.

Holds: the DDC rtol 1e-5 (f32; 1e-12 at f64); the 1D CFAR's flags and
thresholds bit for bit against ``jax.jit`` of the JAX function (whose
window means multiply by the reciprocal, where eager JAX divides), and
the flags equal to the per-column numpy oracle of
``tests/test_realdata.py``; the stage-2 RDM within 1e-5 RMS-relative
(the JAX package runs pocketfft, the port torch's FFT); stage-3 detections
bit for bit on identical maps; stage-4 measurements rtol 1e-5 on identical
detections; the windowed chain's slice 0 equal to the single-frame chain;
the stored ``out_realdata/*/frame_000000.npz`` (example 04's frame)
reproduced from its ``beams``: the RDM within 1e-5, the flags equal, the
measurements within 1e-5 relative."""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config.params import Cfar1DParams as JCfar1D
from radar_tpu.config.params import RadarConfig as JRadar
from radar_tpu.config.params import SigConfig as JSig
from radar_tpu.ops import cfar1d as jc1
from radar_tpu.ops import ddc as jddc
from radar_tpu.ops.cfar import Detections as JDets
from radar_tpu.ops.mtd import zero_velocity_suppress as j_zvs
from radar_tpu.pipeline import stages as js

from radar_tpu_torch.config.params import Cfar1DParams, RadarConfig, \
    SigConfig
from radar_tpu_torch.ops import cfar1d as tc1
from radar_tpu_torch.ops import ddc as tddc
from radar_tpu_torch.ops import mtd as tmtd
from radar_tpu_torch.ops.cfar import Detections
from radar_tpu_torch.pipeline import stages as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORED = os.path.join(REPO, "out_realdata")
T = lambda x: torch.from_numpy(np.array(x))
DET_FIELDS = ("v_idx", "r_idx", "pair_idx", "amp", "valid", "count")
MEAS_FIELDS = ("range_m", "velocity_ms", "elevation_deg", "power")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(prt_num: int = 64, beams: int = 13):
    kw = dict(prt_num=prt_num, channel_num=16, beam_num=beams)
    return JRadar(sig=JSig(**kw)), RadarConfig(sig=SigConfig(**kw))


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.sqrt(np.mean(np.abs(a - b) ** 2))
                 / np.sqrt(np.mean(np.abs(b) ** 2)))


# ---- DDC -------------------------------------------------------------------


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.complex64, 1e-5),
                                        (np.complex128, 1e-12)])
def test_ddc_matches_jax(dtype, rtol):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 403))
    if np.iscomplexobj(np.zeros(1, dtype)):
        x = x + 1j * rng.normal(size=x.shape)
    x = x.astype(dtype)
    want = np.asarray(jddc.ddc(jnp.asarray(x), 60e6, 240e6))
    got = tddc.ddc(T(x), 60e6, 240e6).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    taps = rng.normal(size=7)
    np.testing.assert_allclose(
        tddc.decimation_filter(T(x), taps).numpy(),
        np.asarray(jddc.decimation_filter(jnp.asarray(x), taps)),
        rtol=rtol, atol=rtol * np.abs(x).max())


# ---- segmented 1D CFAR ---------------------------------------------------


def _cfar1d_oracle(x, guard, ref, t, method):
    """Per-column loop port of Function_CFAR1D_sub (debug_v2:467-511), the
    oracle of tests/test_realdata.py:16."""
    rows, cols = x.shape
    flags = np.zeros_like(x, bool)
    for y in range(cols):
        l1, l2 = y - (guard + ref), y - guard - 1
        r1, r2 = y + guard + 1, y + guard + ref
        ref_l = x[:, l1:l2 + 1].mean(axis=1) if l1 >= 0 else \
            x[:, r1:r2 + 1].mean(axis=1)
        ref_r = x[:, r1:r2 + 1].mean(axis=1) if r2 <= cols - 1 else \
            x[:, l1:l2 + 1].mean(axis=1)
        noise = np.maximum(ref_l, ref_r) if method == "GO" else \
            np.minimum(ref_l, ref_r)
        flags[:, y] = x[:, y] >= t * noise
    return flags


def _maps(seed=1, num_v=64, dtype=np.float32, num_q=3):
    rng = np.random.default_rng(seed)
    maps = rng.exponential(size=(num_v, 3404, num_q))
    for v, r, p in [(10, 100, 0), (50, 500, 1), (12, 2000, 2), (5, 3, 0),
                    (40, 3400, 1), (20, 228, 0), (21, 950, 2)]:
        maps[v, r, p % num_q] += 60.0
    return maps.astype(dtype)


def _segmented_oracle(maps, guard, ref, t, method, splits, num_suppress):
    """The per-column oracle per segment and pair, the clutter band
    masked (executeCFAR_2D, debug_v2:442-462)."""
    flags = np.zeros(maps.shape, bool)
    start = 0
    for width in splits:
        for q in range(maps.shape[2]):
            flags[:, start:start + width, q] = _cfar1d_oracle(
                maps[:, start:start + width, q], guard, ref, t, method)
        start += width
    center = (maps.shape[0] + 1) // 2
    flags[center - num_suppress:center + num_suppress + 1] = False
    return flags


@pytest.mark.parametrize("method,ref,guard,dtype,reference", [
    ("GO", 16, 4, np.float32, "jax_jit"), ("SO", 16, 4, np.float32,
                                           "jax_jit"),
    ("CA", 16, 4, np.float32, "jax_jit"), ("GO", 5, 3, np.float32,
                                           "jax_jit"),
    ("CA", 7, 2, np.float32, "jax_jit"), ("SO", 12, 1, np.float64,
                                          "jax_jit"),
    ("GO", 16, 4, np.float64, "numpy_oracle"),
    ("SO", 5, 3, np.float64, "numpy_oracle")])
def test_segmented_cfar_bit_for_bit(method, ref, guard, dtype, reference):
    """Flags and thresholds against ``jax.jit`` of the JAX function, or the
    flags against the per-column numpy oracle of tests/test_realdata.py:16
    run per segment and pair."""
    jsig = JSig(prt_num=64)
    dvb = js._delta_v_bin(jsig)
    maps = _maps(dtype=dtype)
    kw = dict(ref_cells=ref, guard_cells=guard, method=method)
    tf, tt = tc1.segmented_cfar_1d(T(maps), Cfar1DParams(**kw),
                                   jsig.point_prt_segments, dvb)
    assert tf.numpy().sum() >= 5
    if reference == "numpy_oracle":
        want = _segmented_oracle(maps, guard, ref, 8.0, method,
                                 jsig.point_prt_segments,
                                 int(Cfar1DParams().mtd_zero_vel_ms / dvb))
        np.testing.assert_array_equal(tf.numpy(), want)
        return
    jf, jt = jax.jit(lambda m: jc1.segmented_cfar_1d(
        m, JCfar1D(**kw), jsig.point_prt_segments, dvb))(jnp.asarray(maps))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_segment_cfar_matches_numpy_oracle():
    """The segment CFAR against the per-column oracle, edge fallback on
    both sides (as tests/test_realdata.py:37)."""
    rng = np.random.default_rng(0)
    x = rng.exponential(size=(24, 120))
    x[10, 60] += 50.0
    x[5, 3] += 50.0
    x[7, 117] += 50.0
    for method in ("GO", "SO"):
        got, _ = tc1._segment_cfar_1d(T(x), 4, 8, 8.0, method, axis=1)
        np.testing.assert_array_equal(got.numpy(),
                                      _cfar1d_oracle(x, 4, 8, 8.0, method))


def test_threshold_sweep_equals_per_factor_runs():
    """A [T] vector of factors gives [T, V, G, pairs] outputs equal to one
    run per factor, and a 0-d tensor equals the number (the ROC sweep)."""
    sig = SigConfig(prt_num=64)
    dvb = ts._delta_v_bin(sig)
    maps = T(_maps(seed=2, num_q=2))
    ts_ = torch.tensor([3.0, 8.0, 12.0])
    fs, th = tc1.segmented_cfar_1d(maps, Cfar1DParams(),
                                   sig.point_prt_segments, dvb,
                                   threshold_factor=ts_)
    assert fs.shape == (3,) + maps.shape
    for i, t in enumerate(ts_.tolist()):
        f1, t1 = tc1.segmented_cfar_1d(maps, Cfar1DParams(threshold_factor=t),
                                       sig.point_prt_segments, dvb)
        f0, _ = tc1.segmented_cfar_1d(maps, Cfar1DParams(),
                                      sig.point_prt_segments, dvb,
                                      threshold_factor=torch.tensor(t))
        assert torch.equal(fs[i], f1) and torch.equal(th[i], t1)
        assert torch.equal(f0, f1)


@pytest.mark.parametrize("num_v,n", [(32, 3), (333, 5), (64, 0)])
def test_zero_velocity_mask_matches_jax(num_v, n):
    np.testing.assert_array_equal(tc1.zero_velocity_mask(num_v, n).numpy(),
                                  np.asarray(jc1.zero_velocity_mask(num_v,
                                                                    n)))


def test_zero_velocity_suppress_matches_jax():
    rng = np.random.default_rng(4)
    rdm = (rng.normal(size=(32, 40, 3))
           + 1j * rng.normal(size=(32, 40, 3))).astype(np.complex64)
    vel = np.linspace(-20.0, 20.0, 32)
    np.testing.assert_array_equal(
        tmtd.zero_velocity_suppress(T(rdm), vel, 3.0).numpy(),
        np.asarray(j_zvs(jnp.asarray(rdm), jnp.asarray(vel), 3.0)))


# ---- the stages ----------------------------------------------------------


def _stored(name: str, key: str) -> np.ndarray:
    with np.load(os.path.join(STORED, name, "frame_000000.npz")) as f:
        return f[key]


@pytest.fixture(scope="module")
def frame():
    """Example 04's stored frame and the JAX stages on it (computed once)."""
    jcfg, tcfg = _configs()
    beams = _stored("baseband_raw_data", "beams")
    rdm_j, pc_j = jax.jit(lambda b: js.stage2_mtd(b, jcfg))(
        jnp.asarray(beams))
    rdm_j = np.asarray(rdm_j)
    maps = np.asarray(js.pair_sum_maps_realdata(jnp.asarray(rdm_j)))
    dets_j, flags_j = jax.jit(lambda r, m: js.stage3_detection(
        r, jcfg, maps=m))(jnp.asarray(rdm_j), jnp.asarray(maps))
    meas_j = jax.jit(lambda d, r, m: js.stage4_measurement(
        d, r, jcfg, 6, maps=m))(dets_j, jnp.asarray(rdm_j),
                                jnp.asarray(maps))
    return dict(jcfg=jcfg, tcfg=tcfg, beams=beams, rdm_j=rdm_j,
                pc_j=np.asarray(pc_j), maps=maps, dets_j=dets_j,
                flags_j=np.asarray(flags_j), meas_j=meas_j)


def test_stage2_rdm_matches_jax(frame):
    rdm, pc = ts.stage2_mtd(T(frame["beams"]), frame["tcfg"])
    assert rdm.shape == frame["rdm_j"].shape and rdm.dtype == torch.complex64
    assert _rel_rms(pc.numpy(), frame["pc_j"]) < 1e-5
    assert _rel_rms(rdm.numpy(), frame["rdm_j"]) < 1e-5


def test_stage3_detections_bit_for_bit_on_identical_maps(frame):
    dets, flags = ts.stage3_detection(T(frame["rdm_j"]), frame["tcfg"],
                                      maps=T(frame["maps"]))
    np.testing.assert_array_equal(flags.numpy(), frame["flags_j"])
    for f in DET_FIELDS:
        np.testing.assert_array_equal(getattr(dets, f).numpy(),
                                      np.asarray(getattr(frame["dets_j"], f)),
                                      err_msg=f)
    assert int(dets.count) >= 100


def test_stage4_matches_jax_on_identical_detections(frame):
    dj = frame["dets_j"]
    dets = Detections(*(T(np.asarray(getattr(dj, f))) for f in
                        JDets._fields))
    meas = ts.stage4_measurement(dets, T(frame["rdm_j"]), frame["tcfg"], 6,
                                 maps=T(frame["maps"]))
    mj = frame["meas_j"]
    np.testing.assert_array_equal(meas.valid.numpy(), np.asarray(mj.valid))
    np.testing.assert_array_equal(meas.pair_idx.numpy(),
                                  np.asarray(mj.pair_idx))
    for f in MEAS_FIELDS:
        np.testing.assert_allclose(getattr(meas, f).numpy(),
                                   np.asarray(getattr(mj, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


def test_stored_frame_reproduced_from_its_beams(frame):
    """out_realdata/*/frame_000000.npz: the RDM, the CFAR flags and the
    valid measurements, from the stored beams through the port's stages
    2-4."""
    tcfg = frame["tcfg"]
    rdm, _ = ts.stage2_mtd(T(frame["beams"]), tcfg)
    assert _rel_rms(rdm.numpy(), _stored("mtd_data", "rdm")) < 1e-5
    maps = ts.pair_sum_maps_realdata(rdm)
    dets, flags = ts.stage3_detection(rdm, tcfg, maps=maps)
    np.testing.assert_array_equal(flags.numpy(),
                                  _stored("cfar_flags", "flags"))
    meas = ts.stage4_measurement(dets, rdm, tcfg, 6, maps=maps)
    valid = meas.valid.numpy()
    for f in ("range_m", "velocity_ms", "elevation_deg"):
        want = _stored("beam_diff_estimation", f)
        np.testing.assert_allclose(getattr(meas, f).numpy()[valid], want,
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_measure_consts_freq_no_is_zero_based():
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="0-based frequency-point index"):
        ts.measure_consts(tcfg, 11, device="cpu")
    mc = ts.measure_consts(tcfg, 0, device="cpu")
    assert mc.k_slopes_lut.shape == (12,)


def test_stage2_suppress_flag_and_hooks():
    _, tcfg = _configs(prt_num=32)
    rng = np.random.default_rng(0)
    iq = T((rng.normal(size=(32, 3404, 3))
            + 1j * rng.normal(size=(32, 3404, 3))).astype(np.complex64))
    rdm_s, _ = ts.stage2_mtd(iq, tcfg, suppress_zero_vel=True)
    rdm_n, _ = ts.stage2_mtd(iq, tcfg, suppress_zero_vel=False)
    assert bool((rdm_s[16] == 0).all()) and not bool((rdm_n[16] == 0).all())
    assert torch.equal(ts.istc_compensate(iq), iq)
    assert torch.equal(ts.range_concat_dedup(iq), iq)


def _two_frames(prt=32, n_b=3, seed=7):
    jcfg, tcfg = _configs(prt_num=prt, beams=n_b)
    rng = np.random.default_rng(seed)
    two = (rng.normal(size=(2 * prt, 3404, n_b))
           + 1j * rng.normal(size=(2 * prt, 3404, n_b))) * np.sqrt(0.5)
    _, _, p3 = ts._segment_pulses(tcfg)
    seg = np.zeros(3404, complex)
    seg[1200:1200 + len(p3)] = p3
    dop = np.exp(1j * 2 * np.pi * (2 * 10.0 / tcfg.sig.wavelength)
                 * np.arange(2 * prt) * tcfg.sig.prt)
    two += 6.0 * dop[:, None, None] * seg[None, :, None]
    return jcfg, tcfg, two.astype(np.complex64)


def test_windowed_chain_matches_jax_and_slice0_the_single_frame():
    jcfg, tcfg, two = _two_frames()
    p = tcfg.sig.prt_num
    rdm_w, pc_w = ts.stage2_mtd_windowed(T(two[:p]), T(two[p:]), tcfg,
                                         win_size=4)
    want, _ = jax.jit(lambda a, b: js.stage2_mtd_windowed(
        a, b, jcfg, win_size=4))(jnp.asarray(two[:p]), jnp.asarray(two[p:]))
    assert rdm_w.shape == (4, p, 3404, 3)
    assert _rel_rms(rdm_w.numpy(), np.asarray(want)) < 1e-5
    # torch's CPU FFT rounds a row differently at another batch size, so
    # slice 0 is held to the single frame by the stage-2 RMS hold
    rdm_1, pc_1 = ts.stage2_mtd(T(two[:p]), tcfg)
    assert _rel_rms(rdm_w[0].numpy(), rdm_1.numpy()) < 1e-5
    assert _rel_rms(pc_w[:p].numpy(), pc_1.numpy()) < 1e-5
    with pytest.raises(ValueError, match="not divisible"):
        ts.stage2_mtd_windowed(T(two[:p]), T(two[p:]), tcfg, win_size=5)


def test_windowed_pipeline_detects_in_every_slice():
    """The two-frame staged chain on 16-channel IQ with the
    tests/test_realdata.py target (gate 1500, 12 m/s, 12 deg): each slice
    finds it, and slice 0's measurements equal the single-frame chain's."""
    prt = 32
    _, tcfg = _configs(prt_num=prt)
    sig = tcfg.sig
    rng = np.random.default_rng(3)
    two = (rng.normal(size=(2 * prt, 3404, 16))
           + 1j * rng.normal(size=(2 * prt, 3404, 16))) * np.sqrt(0.5)
    _, _, p3 = ts._segment_pulses(tcfg)
    dphi = 2 * np.pi * 0.0138 * np.sin(np.deg2rad(12.0)) / sig.wavelength
    steer = np.exp(-1j * np.arange(16) * dphi)
    dop = np.exp(1j * 2 * np.pi * (2 * 12.0 / sig.wavelength)
                 * np.arange(2 * prt) * sig.prt)
    seg = np.zeros(3404, complex)
    seg[1500:1500 + len(p3)] = p3
    two += 8.0 * dop[:, None, None] * seg[None, :, None] * steer[None, None]
    two = T(two.astype(np.complex64))
    meas, rdm_slices = ts.run_realdata_pipeline_windowed(
        two[:prt], two[prt:], tcfg, freq_no=6, win_size=4)
    assert len(meas) == 4 and rdm_slices.shape[0] == 4
    delta_r = sig.c / (2 * sig.fs)
    for k, m in enumerate(meas):
        v = m.valid.numpy()
        assert v.sum() >= 1, k
        r = m.range_m.numpy()[v][np.argmax(m.power.numpy()[v])]
        assert abs(r - 1500 * delta_r) <= 2 * delta_r + 3.0, k
    single, _, _ = ts.run_realdata_pipeline(two[:prt], tcfg, freq_no=6)
    for f in MEAS_FIELDS + ("valid",):
        np.testing.assert_allclose(getattr(meas[0], f).numpy(),
                                   getattr(single, f).numpy(), rtol=1e-5,
                                   atol=1e-3, err_msg=f)


def test_realdata_modules_load_no_jax():
    """The slice's modules and scripts import neither JAX nor the JAX
    package: a fresh interpreter's ``sys.modules`` after importing them."""
    mods = ["radar_tpu_torch.ops.ddc", "radar_tpu_torch.ops.cfar1d",
            "radar_tpu_torch.ops.cfar_analysis",
            "radar_tpu_torch.pipeline.stages", "radar_tpu_torch.io.binio",
            "radar_tpu_torch.doa.music", "radar_tpu_torch.doa.superres",
            "radar_tpu_torch.doa.monopulse", "radar_tpu_torch.doa.calibrate",
            "radar_tpu_torch.utils.stats",
            "radar_tpu_torch.scripts.run_roc_realdata",
            "radar_tpu_torch.scripts.run_doa_accuracy"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'radar_tpu' or m.startswith('radar_tpu.') "
            "for m in sys.modules), 'radar_tpu imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
