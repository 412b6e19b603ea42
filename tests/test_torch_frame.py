"""PyTorch port: the whole perf-config frame (small widths), held against
the JAX package on injected white noise, plus detection of a truth target,
determinism and the refusals of what the port does not run.

The JAX reference is its XLA chain ``mix_add(signal_rdm, mtd(pc(z)))``
with f32 matmuls, followed by its own qvg kernel-CFAR tail composed as in
``radar_tpu/pipeline/frame.py:279-319``. Tolerances: equal final counts;
range, velocity, angle and power within rtol 1e-4; any difference of the
raw masks confined to cells within 1e-5 (relative) of the threshold."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.cluster.stages import cluster_stage1 as j_stage1
from radar_tpu.cluster.stages import cluster_stage2 as j_stage2
from radar_tpu.config import params as jparams
from radar_tpu.measure.estimate import estimate_parameters as j_estimate
from radar_tpu.ops.cfar import extract_detections as j_extract
from radar_tpu.ops.cfar import goca_noise_and_valid as j_noise
from radar_tpu.ops.mtd import make_mtd_matrix as j_mtd_matrix
from radar_tpu.ops.pallas_kernels import HALO as J_HALO
from radar_tpu.ops.pallas_kernels import goca_cfar_qvg_pallas
from radar_tpu.ops.pallas_kernels import pad_maps_qvg as j_pad
from radar_tpu.ops.pulse_compression import make_matmul_plan as j_matmul_plan
from radar_tpu.pipeline.frame import measure_consts as j_consts
from radar_tpu.pipeline.lowrank import make_lowrank_stages as j_lowrank
from radar_tpu.sim.scenario import TargetBatch as JTargets
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.ops.cfar_kernel import goca_cfar_qvg, pad_maps_qvg
from radar_tpu_torch.ops.noise_rdm import planes_from_compact
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OVER = {**jparams.PERF_OVERRIDES, "matmul_precision": "f32",
        "use_pallas_cfar": True}
TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
FIELDS = ("range_m", "velocity_ms", "angle_deg", "power")


def _rows(t):
    """Valid clustered targets as rows sorted by (range, velocity)."""
    valid = np.asarray(t.valid.cpu() if torch.is_tensor(t.valid)
                       else t.valid)
    cols = [np.asarray(getattr(t, f).cpu() if torch.is_tensor(t.valid)
                       else getattr(t, f))[valid] for f in FIELDS]
    rows = np.stack(cols, axis=1).astype(np.float64)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


@pytest.fixture(scope="module")
def frame_pair():
    jcfg = jparams.small_test_config().replace(**OVER)
    tcfg = tparams.small_test_config().replace(**OVER)
    jpre = j_precompute(jcfg)
    mtd = j_mtd_matrix(jpre.mtd_win, jcfg.sig.prt_num)
    jl = j_lowrank(jcfg, jpre, None, j_matmul_plan(jpre), mtd, jpre.mtd_win,
                   jnp.complex64)
    process = make_frame_processor(tcfg, from_numpy(jpre._asdict()),
                                   device="cpu")
    rplan = process.stages.rplan
    num_b = jpre.dbf_w.shape[0]
    rng = np.random.default_rng(21)
    shape = (num_b, jcfg.sig.prt_num, rplan.s_compact)
    z = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
         * np.sqrt(0.5)).astype(np.complex64)                # [B, P, S_c]

    # JAX: XLA chain + qvg kernel-CFAR tail (frame.py:279-319)
    tb = JTargets.make(*TARGETS)
    rdm = jax.jit(lambda zz: jl.mix_add(jl.signal_rdm(tb),
                                        jl.mtd(jl.pc(zz))))(
        jnp.asarray(z.transpose(1, 2, 0)))
    num_v, num_g = rdm.shape[0], rdm.shape[1]
    mag_q = jnp.abs(jnp.transpose(rdm, (2, 0, 1)))
    maps_qp = j_pad(mag_q[:-1] + mag_q[1:])
    mask, rc = goca_cfar_qvg_pallas(maps_qp, jcfg.cfar, num_g, num_v,
                                    interpret=True)
    maps_q = maps_qp[:, :num_v, J_HALO:J_HALO + num_g]
    dets = j_extract(mask, maps_q, jcfg.cfar.max_detections, layout="qvg",
                     impl="direct", row_counts=rc)
    ip = jcfg.interp
    params = j_estimate(dets, maps_q, rdm, j_consts(jcfg, jpre, np.float32),
                        ip.extra_dots, ip.r_interp_times, ip.v_interp_times,
                        maps_layout="qvg")
    final = j_stage2(j_stage1(params, jcfg.cluster), jcfg.cluster)

    planes = planes_from_compact(torch.from_numpy(z), rplan)
    res = process(0, TargetBatch.make(*TARGETS), noise_planes=planes)
    # the port's raw mask on the same injected noise
    rdm_t = process.stages.noise_rdm_sig(0, TargetBatch.make(*TARGETS),
                                         layout="bvg", planes=planes)
    mag = rdm_t.abs()
    maps_t = pad_maps_qvg(mag[:-1] + mag[1:])
    mask_t, _ = goca_cfar_qvg(maps_t, tcfg.cfar, num_g, num_v)
    noise, _ = j_noise(maps_q, jcfg.cfar, layout="qvg")
    return dict(res=res, final=final, dets=dets, mask=np.asarray(mask),
                mask_t=mask_t.numpy(), maps_q=np.asarray(maps_q),
                thr=np.asarray(jcfg.cfar.threshold_factor * noise),
                tcfg=tcfg, jpre=jpre)


def test_frame_matches_jax_chain(frame_pair):
    res, final = frame_pair["res"], frame_pair["final"]
    assert int(res.num_final) == int(final.count) >= 2
    got, want = _rows(res.targets), _rows(final)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert abs(int(res.num_raw_detections)
               - int(frame_pair["dets"].count)) <= int(
        (frame_pair["mask"] != frame_pair["mask_t"]).sum())


def test_raw_mask_differences_sit_at_the_threshold(frame_pair):
    diff = frame_pair["mask"] != frame_pair["mask_t"]
    g = frame_pair["maps_q"].shape[2]
    d = diff[:, :, :g]
    assert not diff[:, :, g:].any()
    x, thr = frame_pair["maps_q"][d], frame_pair["thr"][d]
    assert np.all(np.abs(x - thr) <= 1e-5 * np.abs(thr))
    assert frame_pair["mask"].sum() >= 10


def test_detects_truth_and_is_deterministic():
    cfg = tparams.small_test_config().replace(**OVER)
    process = make_frame_processor(cfg, device="cpu")
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [20.0])
    a, b = process(7, tb), process(7, tb)
    c = process(8, tb)
    n = int(a.num_final)
    assert n >= 1
    r = a.targets.range_m[a.targets.valid].numpy()
    delta_r = cfg.sig.c / cfg.sig.fs / 2
    assert np.min(np.abs(r - 3000.0)) < 2 * delta_r
    for f in FIELDS + ("valid",):
        assert torch.equal(getattr(a.targets, f), getattr(b.targets, f))
    assert int(a.num_raw_detections) == int(b.num_raw_detections)
    assert not torch.equal(a.targets.power, c.targets.power)


def test_no_target_no_detection():
    cfg = tparams.small_test_config().replace(**OVER)
    process = make_frame_processor(cfg, device="cpu")
    res = process(3, TargetBatch.make([], [], [], []))
    assert int(res.num_final) == 0


@pytest.mark.parametrize("flag,value", [("pc_method", "fft")])
def test_unported_variants_are_refused(flag, value):
    """The kernel routes need the matmul plans and raise JAX's ValueError
    without them (the frame's tail variants are held against JAX in
    test_torch_frame_tails.py)."""
    cfg = tparams.small_test_config().replace(**OVER).replace(**{flag: value})
    with pytest.raises(ValueError, match=flag):
        make_frame_processor(cfg, device="cpu")


def test_nested_unported_variants_are_refused():
    """K1's draws are uniform rails only."""
    base = tparams.small_test_config().replace(**OVER)
    with pytest.raises(ValueError, match="uniform"):
        make_frame_processor(base.replace(noise_dist="normal"), device="cpu")


def test_cuda_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = tparams.small_test_config().replace(**OVER)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_frame_processor(cfg, device="cuda")
