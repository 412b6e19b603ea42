"""PyTorch port: the banded-convolution white-noise PC study
(``radar_tpu_torch/studies/pallas_pc.py``, the plain version of kernel K8)
held against the JAX ``radar_tpu/studies/pallas_pc.py`` run in interpret
mode, and against the port's banded-matmul PC on the compact noise plan.

Tolerances: the plan's integers exact and its filter planes within 1e-7;
at float32 rtol 1e-5, atol 2e-4 (as tests/test_pallas.py: f32 sums of up
to 700 terms in another order); at bfloat16 the RMS of the difference
within 1e-4 of the RMS (same rounded operands, f32 sums in another order,
no intermediate rounding). The kernel runs only on the card (tests marked
``cuda``, in test_torch_cuda.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config.params import small_test_config as j_small
from radar_tpu.studies.pallas_pc import (make_pallas_pc_plan as j_plan,
                                         pulse_compress_noise_pallas)
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.ops.pulse_compression import (compact_noise_plan,
                                                   make_matmul_plan,
                                                   pulse_compress_matmul,
                                                   to_device)
from radar_tpu_torch.studies import pallas_pc as ppc
from radar_tpu_torch.waveform.precompute import from_numpy


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.abs(np.asarray(x, np.complex128)) ** 2)))


@pytest.fixture(scope="module")
def setup():
    jpre = j_precompute(j_small(channels=8, pulses=8))
    tpre = from_numpy(jpre._asdict())
    plan = ppc.make_pallas_pc_plan(tpre, device="cpu")
    rng = np.random.default_rng(0)
    shape = (3, 8, plan.s_compact)
    z = (rng.normal(size=shape) + 1j * rng.normal(size=shape)
         ).astype(np.complex64)
    return dict(jpre=jpre, tpre=tpre, plan=plan, z=z)


@pytest.mark.parametrize("tile", [512, 128])
def test_plan_geometry_matches_jax(setup, tile):
    want = j_plan(setup["jpre"], tile=tile)
    got = ppc.make_pallas_pc_plan(setup["tpre"], tile=tile, device="cpu")
    assert (got.s_compact, got.n_gates) == (want.s_compact, want.n_gates)
    assert len(got.segments) == len(want.segments) == 3
    for g, w in zip(got.segments, want.segments):
        for f in ("c0", "r_len", "pad_front", "pad_tail", "j_len", "tile",
                  "window"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("mr", "mi"):
            np.testing.assert_allclose(getattr(g, f).numpy(), getattr(w, f),
                                       rtol=0, atol=1e-7)
        assert g.window >= g.tile + g.taps - 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matches_jax_kernel(setup, dtype):
    """``pulse_compress_noise`` (plain on the CPU) vs JAX
    ``pulse_compress_noise_pallas(interpret=True)``, same multiply type."""
    jmd, tmd = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    z = setup["z"]
    want = np.asarray(pulse_compress_noise_pallas(
        jnp.asarray(z), j_plan(setup["jpre"]), interpret=True,
        mul_dtype=jmd))
    before = ppc.launch_count
    got = ppc.pulse_compress_noise(torch.from_numpy(z), setup["plan"],
                                   mul_dtype=tmd)
    assert ppc.launch_count == before
    assert got.shape == want.shape and got.dtype == torch.complex64
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-4)
    else:
        assert _rms(got.numpy() - want) <= 1e-4 * _rms(want)
        f32 = ppc.pulse_compress_noise(torch.from_numpy(z), setup["plan"],
                                       mul_dtype=torch.float32).numpy()
        assert 1e-3 * _rms(want) <= _rms(got.numpy() - f32)


def test_matches_banded_matmul_plan(setup):
    """At float32 the study equals the port's banded-matmul PC on the
    compact noise plan (same compact sample layout)."""
    nplan, nlen = compact_noise_plan(make_matmul_plan(setup["tpre"]))
    assert nlen == setup["plan"].s_compact
    z = torch.from_numpy(setup["z"])
    want = pulse_compress_matmul(z.permute(1, 2, 0),
                                 to_device(nplan, "cpu")).permute(2, 0, 1)
    got = ppc.pulse_compress_noise(z, setup["plan"], mul_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=2e-4)


def test_arguments_are_checked(setup):
    z = torch.from_numpy(setup["z"])
    with pytest.raises(ValueError):
        ppc.pulse_compress_noise(z[..., 1:], setup["plan"])
    with pytest.raises(ValueError):
        ppc.pulse_compress_noise(z, setup["plan"], mul_dtype=torch.float16)
