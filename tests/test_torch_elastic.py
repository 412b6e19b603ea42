"""PyTorch port: the elastic path — the sharded fused stream, the
multi-rank checkpoint store and the dp=4 -> dp=2 streaming resume — as
gloo ranks on the CPU: one launch of 4 ranks
(``radar_tpu_torch/parallel/dryrun.py::elastic_save``), then one of 2
(``elastic_resume``) on the stores the first wrote.

- The sharded fused stream (``fused_synth_dbf`` without ``lowrank_rdm``)
  against JAX's ``make_sharded_frame_processor`` on JAX's draws (injected
  with ``noise=``), the port's one-rank reference-stream frame on the same
  channel noise, and the one-rank fused frame on the white beam noise that
  DBF makes of it: equal counts, detection rows at rtol 1e-4 (the
  tolerance of ``test_torch_parallel.py``'s reference stream).
- The store: each rank writes only its rows (the saved chunks' offsets and
  files), a dp=2 restore of the dp=4 save gives each rank its new block,
  and a block of a one-process save is its rows.
- The streaming MC at dp=4 stopped after 2 of 4 scenes and resumed on dp=2
  equals the uninterrupted dp=4 run and the one-rank run bit for bit; the
  manifest accepts the dp route's resume on another dp and refuses the
  sharded route's."""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.parallel.mesh import make_mesh as j_make_mesh
from radar_tpu.parallel.sharded import make_sharded_frame_processor as j_sh
from radar_tpu.sim.echo import add_noise as j_add_noise
from radar_tpu.sim.scenario import TargetBatch as JTargets

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.io.orbax_store import OrbaxFrameStore
from radar_tpu_torch.ops.dbf import dbf_weights_effective_np
from radar_tpu_torch.parallel import dryrun
from radar_tpu_torch.parallel.mesh import Mesh
from radar_tpu_torch.parallel.multihost import run_ranks
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.sim.echo import beam_noise_factor
from radar_tpu_torch.sim.scenario import TargetBatch
from radar_tpu_torch.waveform.precompute import precompute

TARGETS = ([3000.0, 9000.0], [10.0, 20.0], [10.0, 5.0], [18.0, 15.0])
FIELDS = ("range_m", "velocity_ms", "angle_deg", "power")
KW = dict(targets_per_scene=3, trials_per_scene=4, seed=5,
          snr_range=(12.0, 20.0))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores, and these tests
    start ranks of their own: torch runs on one thread here, as in every
    rank (the one-rank runs then sum in the ranks' order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(h: dict) -> np.ndarray:
    v = np.asarray(h["valid"], bool)
    return np.stack([np.asarray(h[f])[v] for f in FIELDS], 1).astype(float)


def _host(res) -> dict:
    t = res.targets
    out = {f: np.asarray(getattr(t, f).cpu() if torch.is_tensor(
        getattr(t, f)) else getattr(t, f)) for f in FIELDS + ("valid",)}
    out["num_final"] = int(res.num_final)
    out["num_raw"] = int(res.num_raw_detections)
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))
    jcfg = jparams.small_test_config().replace(fused_synth_dbf=True)
    key = jax.random.PRNGKey(3)
    shape = (jcfg.sig.prt_num, jcfg.sig.point_prt, jcfg.sig.channel_num)
    noise = np.array(j_add_noise(key, jnp.zeros(shape, jnp.complex64)))
    jax_frame = j_sh(jcfg, j_make_mesh(1, 2, 2))(key, JTargets.make(*TARGETS))
    cfg = tparams.small_test_config().replace(fused_synth_dbf=True)
    tb = TargetBatch.make(*TARGETS)
    # the first "cpu" is the rank programs' device, device= the ranks'
    first = run_ranks(dryrun.elastic_save, 4, root, cfg, noise, tb, KW,
                      "cpu", device="cpu", timeout=300)
    second = run_ranks(dryrun.elastic_resume, 2, root, KW, "cpu",
                       device="cpu", timeout=300)
    return {"root": root, "first": first, "second": second, "noise": noise,
            "cfg": cfg, "tb": tb, "jax": _host(jax_frame)}


def _assert_rows(got: dict, want: dict):
    assert got["num_final"] == want["num_final"] >= 2
    a, b = _rows(got), _rows(want)
    order = lambda r: r[np.lexsort((r[:, 1], r[:, 0]))]
    np.testing.assert_allclose(order(a), order(b), rtol=1e-4)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)])
def test_sharded_fused_stream_matches_jax_and_one_rank(launched, shape):
    """Every rank's sharded fused frame equals JAX's sharded frame, the
    one-rank reference-stream frame on the same channel noise and the
    one-rank fused frame on the beam noise DBF makes of it."""
    cfg, noise, tb = launched["cfg"], launched["noise"], launched["tb"]
    ref = _host(make_frame_processor(cfg.replace(fused_synth_dbf=False),
                                     device="cpu")(7, tb, noise=noise))
    # white z with z @ L^T == noise @ W^T: the fused stream's beam noise
    w_eff = dbf_weights_effective_np(precompute(cfg).dbf_w, cfg.dbf_variant)
    lmat = beam_noise_factor(w_eff)
    z = (noise.astype(np.complex128) @ w_eff.T
         @ np.linalg.inv(lmat).T).astype(np.complex64)
    fused = _host(make_frame_processor(cfg, device="cpu")(7, tb, noise=z))
    for r in launched["first"]:
        got = r["sharded"][shape]
        got = {**got, "num_final": int(got["num_final"]),
               "num_raw": int(got["num_raw"])}
        for want in (launched["jax"], ref, fused):
            _assert_rows(got, want)
        assert got["num_raw"] == ref["num_raw"]


def test_store_ranks_write_their_own_rows(launched):
    """The dp=4 save: each chunk's key carries its global rows, each rank's
    file holds only its own chunks, and the one-process restore is the
    whole batch."""
    import torch.distributed.checkpoint as dcp

    path = os.path.join(launched["root"], "rows", "frame_000001")
    meta = dcp.FileSystemReader(path).read_metadata()
    files = {}
    for idx, info in meta.storage_data.items():
        name, rows = idx.fqn.split("@")
        start, stop = (int(x) for x in rows.split(":"))
        assert stop - start == 3
        files[(name, start)] = info.relative_path
    assert sorted(files) == sorted((n, 3 * r) for n in
                                   ("range_m", "valid", "count")
                                   for r in range(4))
    for (name, start), f in files.items():
        assert f.startswith(f"__{start // 3}_"), (name, start, f)
    whole = OrbaxFrameStore(os.path.dirname(path)).restore(1)
    for name, want in dryrun._store_rows(0, 4).items():
        parts = [dryrun._store_rows(r, 4)[name] for r in range(4)]
        np.testing.assert_array_equal(whole[name], np.concatenate(parts))
        assert whole[name].dtype == want.dtype


def test_store_restores_each_rank_its_new_block(launched):
    """The dp=4 save restored at dp=2: rank r gets rows 6r..6r+5."""
    for r, res in enumerate(launched["second"]):
        for name in ("range_m", "valid", "count"):
            want = np.concatenate([dryrun._store_rows(q, 4)[name]
                                   for q in (2 * r, 2 * r + 1)])
            np.testing.assert_array_equal(res["rows"][name], want)


def test_store_block_of_a_one_process_save(tmp_path):
    """restore(mesh=) on a one-process save: the block of this rank's dp
    index; a count the axis does not split raises."""
    store = OrbaxFrameStore(str(tmp_path))
    store.save(2, {"x": np.arange(12.0).reshape(6, 2),
                   "n": np.array([1, 2, 3, 4, 5, 6], np.int32)})
    mesh = Mesh(shape={"dp": 3, "ch": 1, "cpi": 1},
                coords={"dp": 1, "ch": 0, "cpi": 0}, rank=1,
                device=torch.device("cpu"), backend=None, staging=False)
    got = store.restore(2, mesh=mesh)
    np.testing.assert_array_equal(got["x"], np.arange(4.0, 8.0)
                                  .reshape(2, 2))
    np.testing.assert_array_equal(got["n"], np.array([3, 4], np.int32))
    mesh.shape["dp"] = 4
    with pytest.raises(ValueError, match="do not split"):
        store.restore(2, mesh=mesh)


def test_elastic_streaming_resume_is_bit_exact(launched):
    """dp=4 stopped after 2 of 4 scenes, resumed on dp=2: the statistics
    equal the uninterrupted dp=4 run's and the one-rank run's bit for
    bit, on every rank; the store ends with the 4 scenes."""
    first = [r["streaming"] for r in launched["first"]]
    second = [r["streaming"] for r in launched["second"]]
    want = second[0]["one_rank"]
    assert want.total_targets == 4 * 3 * 4 and want.total_detected > 0
    assert all(f["frames_done"] == [1, 2] for f in first)
    assert all(s["frames_done"] == [1, 2, 3, 4] for s in second)
    for got in [f["uninterrupted"] for f in first] + \
            [s["run"] for s in second]:
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)


def test_manifest_refuses_the_sharded_route_on_another_dp(launched):
    """The dp route records no mesh shape (its resume on dp=2 ran); the
    sharded route records every axis, dp included, so its store written
    at (2, 1, 2) refuses a resume at (1, 1, 2)."""
    root = launched["root"]
    with open(os.path.join(root, "dp", "run_manifest.json")) as f:
        assert json.load(f)["trial_route"] == "dp"
    with open(os.path.join(root, "gspmd", "run_manifest.json")) as f:
        assert json.load(f)["trial_route"] == "gspmd:dp=2xch=1xcpi=2"
    for r in launched["second"]:
        assert "different run" in r["gspmd_error"]
        assert "gspmd:dp=1xch=1xcpi=2" in r["gspmd_error"]
