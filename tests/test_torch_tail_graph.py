"""The frame tail's CUDA graph and the clusterings' label dispatch, on the
CPU, where neither engages.

- ``gated_labels`` is the plain pair ``connected_labels(gate_adjacency(.))``
  here (no kernel launch), and its labels are each component's smallest
  valid member index, an invalid slot's n: the fixpoint that the card's
  kernel (``csrc/connected.cu``) converges to, held here against a BFS in
  numpy's float32 arithmetic (the f32 difference against the f32 gate).
- Every tail (vgq, vgq from the RDM, qvg with K2's plain version, the
  rank-K stream's qvg, kernel-maps and qgv tails) runs eagerly on the CPU
  through ``FrameStages.detect``, the frame processor and the trial
  function: the graph counters stay 0, no graph is kept, and ``detect``
  gives every slot. The card's replays against the eager tail are in
  test_torch_cuda.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from radar_tpu_torch.cluster import connected
from radar_tpu_torch.cluster.connected import (connected_labels,
                                               gate_adjacency, gated_labels)
from radar_tpu_torch.config.params import PERF_OVERRIDES, small_test_config
from radar_tpu_torch.pipeline import frame
from radar_tpu_torch.pipeline.frame import (make_frame_processor,
                                            make_frame_stages)
from radar_tpu_torch.pipeline.montecarlo import make_trial_fn
from radar_tpu_torch.sim.scenario import TargetBatch

TARGETS = ([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0], [20.0, 14.0])
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes on one thread, so the suite's workers do not
    oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(n, rng):
    """A path of n slots in a random slot order, unit steps, gate 1:
    diameter n - 1."""
    x = np.empty(n, F32)
    x[rng.permutation(n)] = np.arange(n, dtype=F32)
    return [(x, 1.0)], np.ones(n, bool)


def _on_gate():
    """Differences that land exactly on the gate in f32: steps of 0.25
    (exact) at gate 0.25, and a pair 0 / f32(0.1) at gate 0.1, adjacent in
    f32 (the gate rounds to the same f32) though f32(0.1) > 0.1 in f64."""
    x = np.concatenate([np.arange(12, dtype=F32) * F32(0.25),
                        F32([100.0, 100.0 + F32(0.1), 200.0])])
    y = np.concatenate([np.zeros(12, F32), F32([0.0, 0.1, 0.0])])
    return [(x, 0.25 + 1e-9), (y, 0.1)], np.ones(len(x), bool)


def _random(n, nf, seed):
    rng = np.random.default_rng(seed)
    fields = [((rng.random(n) * 20).astype(F32), 1.5) for _ in range(nf)]
    return fields, rng.random(n) < 0.8


CASES = {
    "chain7": lambda: ([(F32([6, 0, 2, 3, 1, 5, 4]), 1.0)],
                       np.ones(7, bool)),
    "path512": lambda: _path(512, np.random.default_rng(3)),
    "on_gate": _on_gate,
    "random96_two_fields": lambda: _random(96, 2, 0),
    "random517_three_fields": lambda: _random(517, 3, 1),
    "all_invalid": lambda: ([(np.zeros(40, F32), 1.0)], np.zeros(40, bool)),
    "one_slot": lambda: ([(F32([3.0]), 1.0)], np.ones(1, bool)),
    # past the card kernel's MAX_SLOTS: the CPU's plain pair has no cap
    "path_past_the_kernels_slots": lambda: _path(connected.MAX_SLOTS + 3,
                                                 np.random.default_rng(11)),
}


def _smallest_member(fields, valid) -> np.ndarray:
    """Labels by BFS over the f32 gate graph: a component's smallest
    valid member index, n for an invalid slot."""
    n = len(valid)
    adj = valid[:, None] & valid[None, :]
    for f, gate in fields:
        adj &= np.abs(f[:, None] - f[None, :]) <= F32(gate)
    comp = connected.connected_components_np(adj)
    first = {}
    for i in range(n):
        first.setdefault(comp[i], i)
    return np.where(valid, [first[c] for c in comp], n)


@pytest.mark.parametrize("case", list(CASES))
def test_gated_labels_are_the_plain_pair_on_cpu(case):
    fields, valid = CASES[case]()
    t = [(torch.from_numpy(f), g) for f, g in fields]
    ok = torch.from_numpy(valid)
    before = connected.launch_count
    got = gated_labels(t, ok)
    assert connected.launch_count == before
    assert got.dtype == torch.int64
    want = connected_labels(gate_adjacency(t, ok), ok)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  _smallest_member(fields, valid))


def test_banded_means_tensor_is_kept_for_the_process():
    """A tail graph reads the matmul-means CFAR's banded matrix at its
    address, so the cache never drops it: after more other keys than a
    bounded cache would hold, a key gives the same tensor."""
    from radar_tpu_torch.ops import cfar

    first = cfar._banded_means_tensor(10, 5, 128, torch.float32, "cpu")
    for tile in range(8, 48):
        cfar._banded_means_tensor(10, 5, tile, torch.float32, "cpu")
    assert cfar._banded_means_tensor(10, 5, 128, torch.float32,
                                     "cpu") is first


_PERF = small_test_config().replace(**{**PERF_OVERRIDES,
                                       "matmul_precision": "f32"})
TAILS = {
    "vgq": (small_test_config(), "vgq"),
    "vgq_from_rdm": (small_test_config().replace(tail_from_rdm=True), "vgq"),
    "qvg_k2": (small_test_config().replace(use_pallas_cfar=True), "qvg"),
    "rank_k_qvg": (_PERF.replace(noise_rdm_impl="pallas"), "qvg"),
    "kernel_maps": (_PERF.replace(kernel_maps=True), "kernel_maps"),
    "qgv": (_PERF.replace(beams_major_tail=True), "qgv"),
}


def _graph_counts():
    return frame.tail_graph_captures, frame.tail_graph_replays


@pytest.mark.parametrize("case", list(TAILS))
def test_tail_graph_never_engages_on_cpu(case):
    """``detect`` runs the tail eagerly (every slot given, no graph kept),
    and so do the frame processor and the trial function: the graph
    counters stay 0."""
    cfg, tail = TAILS[case]
    tb = TargetBatch.make(*TARGETS)
    st = make_frame_stages(cfg, device="cpu")
    assert st.tail == tail and st.graphs == {}
    before = _graph_counts()
    lr = st.lowrank
    maps_p = None
    if lr is None:
        rdm, layout = st.chain(st.synth(tb), 3)[-1], "vgb"
    elif tail == "kernel_maps":
        (rdm, maps_p), layout = lr.noise_rdm_sig(3, tb, layout="bvg",
                                                 emit_maps=True), "bvg"
    else:
        rdm, layout = lr.noisy_rdm(lr.signal_rdm(tb, lr.rdm_layout), 3,
                                   None, None), lr.rdm_layout
    out = st.detect(rdm, layout, maps_p)
    assert len(out) == 5 and all(x is not None for x in out[1:])
    assert int(out[-1].num_final) >= 2
    assert st.graphs == {}
    res = make_frame_processor(cfg, device="cpu")(3, tb)
    assert int(res.num_final) == int(out[-1].num_final)
    make_trial_fn(cfg, device="cpu")(tb, [1, 2])
    assert _graph_counts() == before == (0, 0)


def test_each_stage_set_keeps_its_own_graphs_and_the_taps_none():
    """A stage set's graphs live and die with it; ``return_intermediates``
    (the reference stream's debug taps) keeps none: its tail is eager."""
    cfg = small_test_config()
    a, b = (make_frame_stages(cfg, device="cpu") for _ in range(2))
    assert a.graphs == {} and b.graphs == {} and a.graphs is not b.graphs
    assert make_frame_stages(cfg, device="cpu",
                             return_intermediates=True).graphs is None
