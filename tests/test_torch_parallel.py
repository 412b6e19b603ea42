"""PyTorch port of ``radar_tpu/parallel/``: the mesh, the multi-process
helpers and the explicit collectives, as gloo ranks on the CPU
(``run_ranks``) against JAX's ``shard_map`` collectives on the suite's 8
virtual CPU devices (``tests/test_parallel.py``'s cases). Each module
fixture is one launch of 8 ranks; the rank programs live in
``radar_tpu_torch/parallel/dryrun.py``."""

import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest

from radar_tpu.config.params import small_test_config
from radar_tpu.parallel.collectives import (covariance_snapshot_sharded,
                                            dbf_channel_sharded,
                                            mtd_cpi_sharded)
from radar_tpu.parallel.mesh import make_mesh as j_make_mesh
from radar_tpu.waveform.precompute import precompute
from radar_tpu_torch.parallel import dryrun, multihost
from radar_tpu_torch.parallel.multihost import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def layout():
    return run_ranks(dryrun.layout, 8, "cpu", device="cpu", timeout=180)


def _rand_c(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.fixture(scope="module")
def collectives():
    """The inputs of tests/test_parallel.py:28-69 (complex128), the port's
    results from every rank, and JAX's sharded results."""
    rng = np.random.default_rng(0)
    iq, w = _rand_c(rng, (3, 64, 16)), _rand_c(rng, (13, 16))
    pc = _rand_c(np.random.default_rng(2), (32, 64, 3))
    x = _rand_c(np.random.default_rng(3), (16, 256))
    win = np.asarray(precompute(small_test_config(pulses=32)).mtd_win)
    ranks = run_ranks(dryrun.collectives, 8, iq, w, pc, win, x, "cpu",
                      device="cpu", timeout=180)
    jax_out = {
        "dbf": np.asarray(dbf_channel_sharded(j_make_mesh(ch=4), "ch")(
            jnp.asarray(iq), jnp.asarray(w))),
        "mtd": np.asarray(mtd_cpi_sharded(j_make_mesh(cpi=4),
                                          jnp.asarray(win))(jnp.asarray(pc))),
        "cov": np.asarray(covariance_snapshot_sharded(j_make_mesh(cpi=8))(
            jnp.asarray(x)))}
    return ranks, jax_out


def test_parallel_import_loads_no_jax():
    """``import radar_tpu_torch.parallel`` (every module of the layer) loads
    neither JAX nor ``radar_tpu``: a spawned rank must not."""
    code = ("import sys, radar_tpu_torch.parallel, "
            "radar_tpu_torch.parallel.dp, radar_tpu_torch.parallel.dryrun; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'radar_tpu' or m.startswith('radar_tpu.') "
            "for m in sys.modules), 'radar_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_mesh_coordinates_are_row_major(layout):
    """Rank r sits where np.arange(8).reshape(2, 2, 2) puts r (JAX's
    mesh.py:38 device order), and each axis group holds the ranks that
    differ only on that axis."""
    grid = np.arange(8).reshape(2, 2, 2)
    for r, out in enumerate(layout):
        d, c, q = np.unravel_index(r, (2, 2, 2))
        assert out["rank"] == r
        assert out["coords"] == {"dp": d, "ch": c, "cpi": q}
        assert out["group_ranks"][("dp",)] == grid[:, c, q].tolist()
        assert out["group_ranks"][("ch",)] == grid[d, :, q].tolist()
        assert out["group_ranks"][("cpi",)] == grid[d, c, :].tolist()
        assert out["group_ranks"][("dp", "cpi")] == \
            grid[:, c, :].reshape(-1).tolist()
        assert out["group_ranks"][("dp", "ch", "cpi")] == list(range(8))


def test_mesh_all_reduce_runs_on_each_group(layout):
    """An all-reduce over each axis group sums exactly that group's
    ranks."""
    for out in layout:
        for g, ranks in out["group_ranks"].items():
            assert out["group_sums"][g] == sum(ranks)


def test_mesh_records_transport(layout):
    """CPU ranks run gloo with no host staging."""
    for out in layout:
        assert (out["backend"], out["staging"], out["device"]) == \
            ("gloo", False, "cpu")
        assert out["initialize"] is True        # the group is already up


def test_multihost_mesh_and_batch_slice(layout):
    """tests/test_parallel.py:119-127 on 8 ranks: make_multihost_mesh(ch=2)
    infers dp=4; each rank owns its dp row's slice of a batch of 8; a batch
    of 6 raises."""
    for r, out in enumerate(layout):
        assert out["multihost_shape"] == {"dp": 4, "ch": 2, "cpi": 1}
        d = r // 2
        assert out["batch_slice"] == slice(2 * d, 2 * d + 2)
        assert "not divisible" in out["indivisible"]


def test_initialize_without_environment_is_false(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False


@pytest.mark.parametrize("name", ["dbf", "mtd", "cov"])
def test_collectives_match_jax(collectives, name):
    """dbf_channel_sharded (ch=4), mtd_cpi_sharded (all_to_all there and
    back, cpi=4) and covariance_snapshot_sharded (cpi=8) within rtol 1e-10
    of JAX's shard_map versions at complex128, on every rank."""
    ranks, jax_out = collectives
    for out in ranks:
        np.testing.assert_allclose(out[name], jax_out[name], rtol=1e-10,
                                   atol=1e-10)


def test_run_ranks_raises_when_a_rank_raises():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised"):
        run_ranks(dryrun.raise_on, 2, 1, device="cpu", timeout=120)
    assert time.monotonic() - t0 < 60


def test_run_ranks_raises_at_its_timeout():
    """A rank that outlives the timeout is killed with the others, and the
    launcher raises within the timeout (plus the kill)."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not return"):
        run_ranks(dryrun.sleep_on, 2, 1, 600.0, device="cpu", timeout=15)
    assert time.monotonic() - t0 < 15 + 10
