"""PyTorch port: ``python -m radar_tpu_torch.scripts.validate_rdm_gen`` and
``run_kernel_bench`` (the counterparts of ``scripts/validate_rdm_gen.py``
and ``scripts/run_kernel_bench.py``) through their ``main`` at ``--cpu
--small``, and a guard that the modules this slice adds load neither JAX
nor the JAX package.

validate_rdm_gen's checks on the CPU run K1's, K1c's and K4's plain
versions: the bit check and the rolling check at exactly 0 (the plain
draw mode draws K1c's planes, and K4's plain version is K1's), the
moments' variance ratio within 2% of 1. The kernel bench's five arms each
report a positive host time a call (no device metric on the CPU)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from radar_tpu_torch.scripts import run_kernel_bench, validate_rdm_gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = (
    "radar_tpu_torch.scripts.run_multiprocess",
    "radar_tpu_torch.scripts.validate_rdm_gen",
    "radar_tpu_torch.scripts.run_kernel_bench",
    "radar_tpu_torch.io.orbax_store", "radar_tpu_torch.parallel.dryrun",
    *(f"radar_tpu_torch.examples.{n}" for n in (
        "01_pulse_compression_basics", "02_single_frame_debug",
        "03_music_doa", "04_realdata_stages", "05_elastic_checkpointing",
        "06_five_target_tracking", "07_multichip_sharding")))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores, and these tests
    start ranks of their own: torch runs on one thread here, as in every
    rank (the one-rank runs then sum in the ranks' order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_validate_rdm_gen_main(tmp_path):
    out = validate_rdm_gen.main(["--cpu", "--small", "--out",
                                 str(tmp_path / "rg.json")])
    assert out["bit_check"]["max_abs_diff"] == 0.0
    assert out["rolling_check"]["max_abs_diff"] == 0.0
    assert out["bit_check"]["pass"] and out["rolling_check"]["pass"]
    assert abs(out["var_ratio"] - 1.0) < 0.02 and out["moments_pass"]
    assert abs(out["var_ratio_normal"] - 1.0) < 0.02
    assert out["device"] == "cpu"
    with open(tmp_path / "rg.json") as fh:
        assert json.load(fh)["bit_check"] == out["bit_check"]


def test_run_kernel_bench_main(tmp_path):
    out = run_kernel_bench.main(["--cpu", "--small", "--out",
                                 str(tmp_path / "kb.json")])
    arms = [k for k, v in out.items() if isinstance(v, dict)]
    assert arms == ["dbf_8ch_5beam", "pulse_compression_matmul",
                    "mtd_32pt", "music_16el_128snap_3600grid",
                    "music2d_16el_4x4ura_121x71grid"]
    for name in arms:
        assert out[name]["host_ms"] > 0 and "ms" not in out[name], name
        assert out[name]["device"] == "cpu"
    assert out["music2d_16el_4x4ura_121x71grid"]["grid_points"] == 121 * 71
    with open(tmp_path / "kb.json") as fh:
        assert sorted(json.load(fh)) == sorted(out)


def test_new_modules_load_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'radar_tpu' or m.startswith('radar_tpu.') "
            "for m in sys.modules), 'radar_tpu imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
