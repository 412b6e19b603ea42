"""PyTorch port (radar_tpu_torch): package hygiene, configuration, host
constants and plans, held field by field against the JAX package."""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import radar_tpu.config.params as jparams
import radar_tpu.config.assets as jassets
from radar_tpu.ops.mtd import make_mtd_matrix as j_make_mtd_matrix
from radar_tpu.ops.pallas_rdm import make_rdm_plan as j_make_rdm_plan
from radar_tpu.ops.pulse_compression import (
    compact_noise_plan as j_compact_noise_plan,
    make_matmul_plan as j_make_matmul_plan)
from radar_tpu.waveform.precompute import precompute as j_precompute

import radar_tpu_torch.config.params as tparams
from radar_tpu_torch.config import assets as tassets
from radar_tpu_torch.ops.mtd import make_mtd_matrix
from radar_tpu_torch.ops.noise_rdm import make_rdm_plan
from radar_tpu_torch.ops.pulse_compression import (compact_noise_plan,
                                                   make_matmul_plan)
from radar_tpu_torch.waveform.precompute import (Precomputed, from_numpy,
                                                 precompute)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "radar_tpu_torch")


def _configs(mod):
    return {"small": mod.small_test_config(), "full": mod.full_config(),
            "perf": mod.perf_config(),
            "perf_small": mod.small_test_config().replace(
                **{**mod.PERF_OVERRIDES, "use_pallas_cfar": True})}


def _assert_field_equal(name, got, want):
    if isinstance(want, np.ndarray):
        assert got.shape == want.shape, name
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=name)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12), name
    else:
        assert got == want, name


def test_import_loads_no_jax():
    """``import radar_tpu_torch`` (every module of the slice) must not load
    JAX: run in a fresh interpreter."""
    code = ("import sys, radar_tpu_torch, radar_tpu_torch.pipeline.frame, "
            "radar_tpu_torch.ops.noise_rdm, radar_tpu_torch.ops.cfar_kernel, "
            "radar_tpu_torch.ops.awgn, radar_tpu_torch.pipeline.driver, "
            "radar_tpu_torch._build; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'radar_tpu' or m.startswith('radar_tpu.') "
            "for m in sys.modules), 'radar_tpu imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_neither_jax_nor_radar_tpu():
    pat = re.compile(r"^\s*(import|from) (jax|radar_tpu)\b")
    bad = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    bad += [f"{path}:{i + 1}" for i, line in enumerate(fh)
                            if pat.match(line)]
    assert not bad, bad


@pytest.mark.parametrize("name", ["small", "full", "perf", "perf_small"])
def test_config_trees_match_jax(name):
    """Same field names, defaults and derived properties as the JAX
    configuration tree."""
    a = dataclasses.asdict(_configs(tparams)[name])
    b = dataclasses.asdict(_configs(jparams)[name])
    assert a == b
    ta, ja = _configs(tparams)[name].sig, _configs(jparams)[name].sig
    for prop in ("wavelength", "point_prt", "n_total_gate", "v_max",
                 "frame_time"):
        assert getattr(ta, prop) == getattr(ja, prop), prop
    assert tparams.PERF_OVERRIDES == jparams.PERF_OVERRIDES


def test_assets_match_jax():
    np.testing.assert_array_equal(tassets.fir_taps(), jassets.fir_taps())
    np.testing.assert_array_equal(tassets.dbf_coeffs(), jassets.dbf_coeffs())
    np.testing.assert_array_equal(tassets.angle_k_table(),
                                  jassets.angle_k_table())
    for k in ("BEAM_ANGLES_DEG_16CH", "K_SLOPES_LUT_16CH",
              "BEAM_ANGLES_DEG_REALDATA"):
        np.testing.assert_array_equal(getattr(tassets, k),
                                      getattr(jassets, k))


@pytest.mark.parametrize("name", ["small", "full"])
def test_precompute_matches_jax(name):
    """The port's own host precompute equals JAX's, field by field, at
    float64 rtol 1e-12."""
    got = precompute(_configs(tparams)[name])
    want = j_precompute(_configs(jparams)[name])
    assert Precomputed._fields == type(want)._fields
    for field in Precomputed._fields:
        _assert_field_equal(field, getattr(got, field), getattr(want, field))


def test_from_numpy_carries_jax_constants_exactly():
    want = j_precompute(jparams.small_test_config())
    got = from_numpy(want._asdict())
    for field in Precomputed._fields:
        g, w = getattr(got, field), getattr(want, field)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            assert g == w, field
    with pytest.raises(KeyError):
        from_numpy({"tx_pulse": want.tx_pulse})


def test_matmul_plans_match_jax():
    pre = j_precompute(jparams.small_test_config())
    got, want = make_matmul_plan(pre), j_make_matmul_plan(pre)
    assert len(got.chunks) == len(want.chunks)
    for (g0, gl, gm), (w0, wl, wm) in zip(got.chunks, want.chunks):
        assert (g0, gl) == (w0, wl)
        np.testing.assert_array_equal(gm, wm)
    (cg, ng), (cw, nw) = compact_noise_plan(got), j_compact_noise_plan(want)
    assert ng == nw
    assert [c[:2] for c in cg.chunks] == [c[:2] for c in cw.chunks]


@pytest.mark.parametrize("name", ["small", "full"])
def test_rdm_plan_matches_jax(name):
    """Segment geometry (compact offsets, pads, gates, tile, window) and the
    banded filter matrices equal the JAX plan built with tile=128,
    lane=128; the MTD matrix is JAX's un-padded DFT."""
    cfg = _configs(jparams)[name]
    pre = j_precompute(cfg)
    mtd = j_make_mtd_matrix(pre.mtd_win, cfg.sig.prt_num, cfg.mtd_fft_len)
    np.testing.assert_array_equal(
        make_mtd_matrix(pre.mtd_win, cfg.sig.prt_num, cfg.mtd_fft_len), mtd)
    want = j_make_rdm_plan(pre, mtd, cfg.sig.prt_num, tile=128, lane=128)
    got = make_rdm_plan(pre, mtd, cfg.sig.prt_num, tile=128, lane=128,
                        device="cpu")
    assert (got.s_compact, got.n_gates, got.n_dop) == (
        want.s_compact, want.n_gates, want.n_dop)
    g0 = 0
    for gs, ws in zip(got.segments, want.segments):
        for f in ("c0", "r_len", "pad_front", "pad_tail", "j_len", "tile",
                  "window"):
            assert getattr(gs, f) == getattr(ws, f), f
        assert gs.g0 == g0
        g0 += gs.j_len
        assert gs.pad_front + gs.r_len + gs.pad_tail >= gs.xlen
        np.testing.assert_array_equal(gs.mp.numpy(),
                                      (ws.mpr + 1j * ws.mpi).astype(
                                          np.complex64))
    v, p = want.n_dop, cfg.sig.prt_num
    d = got.d.numpy()
    np.testing.assert_array_equal(d.real, want.dr[:v, :p])
    np.testing.assert_array_equal(d.imag, want.di[:v, :p])
    assert got.d.dtype == torch.complex64
