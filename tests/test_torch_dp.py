"""PyTorch port of ``radar_tpu/parallel/dp.py`` and ``sharded.py`` and of
the mesh routes of the Monte-Carlo studies, as 4 gloo ranks on the CPU
(one launch of ``radar_tpu_torch/parallel/dryrun.py::frames``).

Each is held against the port's own single-rank run on the same seeds,
computed on one of the ranks: a dp batch, the dp trials,
``snr_sweep(mesh=)`` and ``run_streaming_mc(mesh=, dp_trials=True)`` bit
for bit (the ``tests/test_dp.py:41-68`` contract); a frame sharded over
(ch, cpi) with exact counts and fields within rtol 1e-4 (the DBF's partial
sums are added in another order). JAX's draws cannot be matched through
JAX's sharded processor, which draws inside it: the chain to JAX is the
single-rank parity of ``test_torch_refframe.py`` and
``test_torch_lowrank.py``."""

import numpy as np
import pytest

from radar_tpu_torch.parallel import dryrun
from radar_tpu_torch.parallel.multihost import run_ranks

FIELDS = ("range_m", "velocity_ms", "angle_deg", "power")


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(dryrun.frames, 4, "cpu", device="cpu", timeout=300)


def _merged(ranks, key):
    out = {}
    for r in ranks:
        out.update(r[key])
    return out


def _assert_frame(got, want, exact: bool):
    for k in ("num_raw", "num_final", "valid"):
        np.testing.assert_array_equal(got[k], want[k])
    v = np.asarray(want["valid"], bool)
    assert v.any()
    for f in FIELDS:
        if exact:
            np.testing.assert_array_equal(got[f], want[f])
        else:
            np.testing.assert_allclose(got[f][v], want[f][v], rtol=1e-4)


@pytest.mark.parametrize("stream", ["stream", "lowrank"])
@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)])
def test_sharded_frame_matches_single_rank(ranks, shape, stream):
    """make_sharded_frame_processor at (dp, ch, cpi): the channel-sharded
    reference stream (all-reduce DBF, all-to-all into the MTD) and the
    rank-K xla stream, on every rank, equal the single-rank frame."""
    want = ranks[0]["single"][stream]
    for r in ranks:
        _assert_frame(r["sharded"][(shape, stream)], want, exact=False)


@pytest.mark.parametrize("label", [
    "perf:make_dp_frame_processor", "perf_xla:make_dp_frame_processor",
    "stream:make_dp_sharded_frame_processor"])
def test_dp_batch_matches_single_rank(ranks, label):
    """The perf path's kernel route (K1 and K2's plain versions) at dp=4,
    its xla route at dp=2 with an inert ch=2, and dp=2 x ch=2 sharded
    frames: every frame of the gathered batch, on every rank, equals the
    single-rank frame of its seed (bit for bit; the sharded frames to the
    DBF's reassociation)."""
    singles = _merged(ranks, "dp_single")
    n = len(ranks[0]["dp"][label]["num_final"])
    exact = "sharded" not in label
    for r in ranks:
        batch = r["dp"][label]
        for j in range(n):
            _assert_frame({k: v[j] for k, v in batch.items()},
                          singles[(label, j)], exact)
    for r in ranks:
        assert "not divisible" in r["errors"][label]


def test_dp_trials_match_single_rank(ranks):
    angles, hits = ranks[1]["trials_single"]
    assert hits.any()
    for r in ranks:
        np.testing.assert_array_equal(r["trials"][0], angles)
        np.testing.assert_array_equal(r["trials"][1], hits)


def test_snr_sweep_dp_mesh_matches_one_rank(ranks):
    """snr_sweep(mesh=dp4) equals the one-rank sweep trial for trial, on
    every rank; Pd rises from -42 dB to 25 dB; bad divisibility raises."""
    want = ranks[1]["sweep_single"]
    pd = np.mean(~np.isnan(want), axis=1)
    assert pd[0] <= 0.3 and pd[-1] >= 0.9
    for r in ranks:
        np.testing.assert_array_equal(r["sweep"], want)
        assert "multiples of the dp" in r["errors"]["sweep"]


@pytest.mark.parametrize("route", ["dp", "sharded"])
def test_streaming_mc_mesh_matches_one_rank(ranks, route):
    """run_streaming_mc(mesh=dp4, dp_trials=True) equals the one-rank run
    exactly; with mesh=(1, 2, 2) and every frame sharded, the detections
    and the statistics equal it to the DBF's reassociation. On the dp
    route, a run with store= that saves every scene and the rerun that
    replays them all (each rank its own rows) equal it too."""
    owner = {"dp": 2, "sharded": 3}[route]
    want = ranks[owner][f"streaming_{route}_single"]
    assert want.total_detected > 0
    for r in ranks:
        got = r[f"streaming_{route}"]
        assert got.total_targets == want.total_targets
        assert got.total_detected == want.total_detected
        np.testing.assert_array_equal(got.snr_bin_rate, want.snr_bin_rate)
        if route == "dp":
            assert (got.range_rmse_m, got.velocity_rmse_ms) == \
                (want.range_rmse_m, want.velocity_rmse_ms)
            assert r["store_frames"] == [1, 2]
            for stored in r["streaming_dp_store"]:
                for f in want._fields:
                    np.testing.assert_array_equal(getattr(stored, f),
                                                  getattr(want, f))
        else:
            np.testing.assert_allclose(
                [got.range_rmse_m, got.velocity_rmse_ms],
                [want.range_rmse_m, want.velocity_rmse_ms], rtol=1e-4)
