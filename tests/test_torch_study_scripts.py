"""PyTorch port: the detection studies' entry points — ``python -m
radar_tpu_torch.scripts.run_roc``, ``run_pfa``, ``run_roc_full``,
``run_pfa_means_ab`` and ``run_monopulse_ab`` — at tiny sizes on the CPU.

- One subprocess runs the five in turn and loads neither JAX, nor the JAX
  package, nor matplotlib; their JSON keys hold those of the committed
  artifacts (``results/roc.json``, ``pfa_calibration.json``,
  ``roc_full.json``, ``pfa_matmul_recheck.json``,
  ``monopulse_refined_ab.json``).
- Their deterministic fields equal the artifacts' (rtol 1e-6):
  ``run_roc``'s threshold factors and analytic Pfa at the small config,
  ``run_pfa``'s analytic columns at the artifact's full config.
- ``run_pfa``'s exponential validation counts equal JAX's counters on the
  same numpy cells.
- Without a card, without ``--cpu``, each script exits before any work;
  a figure asked for without matplotlib exits naming it."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.ops import cfar_analysis as jca
from radar_tpu.waveform.precompute import precompute as j_precompute

from radar_tpu_torch.config.params import full_config, small_test_config
from radar_tpu_torch.scripts import (run_monopulse_ab, run_pfa,
                                     run_pfa_means_ab, run_roc, run_roc_full)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_LOADED = ("bad = [m for m in sys.modules if m in ('jax', 'matplotlib',"
              " 'radar_tpu') or m.startswith(('jax.', 'matplotlib.',"
              " 'radar_tpu.'))]; assert not bad, bad")


def _artifact(name):
    with open(os.path.join(REPO, "results", name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """The five scripts in turn in one subprocess: their JSON reports."""
    t = str(tmp_path_factory.mktemp("studies"))
    calls = [
        ("run_roc", ["--cpu", "--trials", "3", "--noise-frames", "2",
                     "--out", t + "/roc.json"]),
        ("run_pfa", ["--cpu", "--small", "--frames", "2", "--exp-frames",
                     "1", "--out", t + "/pfa.json"]),
        ("run_roc_full", ["--cpu", "--small", "--snr=0", "--trials", "3",
                          "--noise-frames", "2", "--out",
                          t + "/roc_full.json"]),
        ("run_pfa_means_ab", ["--cpu", "--small", "--exp-frames", "1",
                              "--frames", "1", "--out", t + "/ab.json"]),
        ("run_monopulse_ab", ["--cpu", "--small", "--snrs=0,20",
                              "--trials", "3", "--out", t + "/mono.json"]),
    ]
    code = "import sys\n"
    for mod, argv in calls:
        code += (f"from radar_tpu_torch.scripts import {mod}\n"
                 f"{mod}.main({argv!r})\n")
    code += NOT_LOADED + "\n"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    names = ("roc", "pfa", "roc_full", "ab", "mono")
    out = {n: json.load(open(f"{t}/{n}.json")) for n in names}
    out["stdout"] = proc.stdout
    return out


@pytest.mark.parametrize("name,artifact", [
    ("roc", "roc.json"), ("pfa", "pfa_calibration.json"),
    ("roc_full", "roc_full.json"), ("ab", "pfa_matmul_recheck.json"),
    ("mono", "monopulse_refined_ab.json")])
def test_reports_hold_the_artifacts_keys(reports, name, artifact):
    rep, want = reports[name], _artifact(artifact)
    assert set(want) <= set(rep), set(want) - set(rep)
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(v) <= set(rep[k]), (k, set(v) - set(rep[k]))
    assert rep["device"] == "cpu"


def test_run_roc_deterministic_fields_equal_the_artifact(reports):
    rep, want = reports["roc"], _artifact("roc.json")
    assert rep["config"] == want["config"] and rep["snr_db"] == want["snr_db"]
    np.testing.assert_allclose(rep["t_factors"], want["t_factors"],
                               rtol=1e-6)
    np.testing.assert_allclose(rep["pfa_analytic_exponential"],
                               want["pfa_analytic_exponential"], rtol=1e-6)
    # the truth found at low thresholds, lost at high ones
    assert rep["pd"][0] == 1.0 and rep["pd"][-1] == 0.0
    assert rep["pfa_hits"] == sorted(rep["pfa_hits"], reverse=True)
    assert rep["launches"] == {"K1": 0, "K1c": 0, "K2": 0, "K3": 0, "K5": 0,
                               "labels": 0, "tail_captures": 0,
                               "tail_replays": 0}


def test_run_pfa_analytic_columns_equal_the_artifact(reports):
    """At the artifact's full config, the script's analytic columns are
    the artifact's; the small run's JSON carries its own config's."""
    want = _artifact("pfa_calibration.json")
    val = want["exponential_validation"]
    cols = run_pfa.analytic_columns(full_config())
    np.testing.assert_allclose(cols["sim_2d"],
                               [r["analytic"] for r in val["sim_2d"]],
                               rtol=1e-6)
    np.testing.assert_allclose(cols["realdata_1d"],
                               [r["analytic"] for r in val["realdata_1d"]],
                               rtol=1e-6)
    for fam, rows in val["closed_form_cross_checks"].items():
        for t, pair in rows.items():
            for k in ("closed", "quadrature"):
                np.testing.assert_allclose(
                    cols["closed_form_cross_checks"][fam][t][k], pair[k],
                    rtol=1e-6, err_msg=f"{fam} {t} {k}")
    rep = reports["pfa"]["exponential_validation"]
    small = run_pfa.analytic_columns(small_test_config())
    assert [r["analytic"] for r in rep["sim_2d"]] == small["sim_2d"]
    assert [r["analytic"] for r in rep["realdata_1d"]] == \
        small["realdata_1d"]
    assert rep["t_factors"] == val["t_factors"]


def test_run_pfa_exponential_counts_equal_jax(reports):
    """The exponential cells are numpy's ``default_rng(0)`` draws in both
    packages, so JAX's counters on the same cells give the same hits."""
    rep = reports["pfa"]["exponential_validation"]
    cfg = jparams.small_test_config()
    pre = j_precompute(cfg)
    shape = (cfg.sig.prt_num, pre.n_total_gate, cfg.sig.beam_num - 1)
    x = jnp.asarray(np.random.default_rng(0).exponential(size=shape)
                    .astype(np.float32))
    ts = run_pfa.T_VALIDATE
    c2, n2 = jax.jit(lambda m: jca.count_exceedances_2d(m, cfg.cfar, ts))(x)
    c1, n1 = jax.jit(lambda m: jca.count_exceedances_1d_interior(
        m, cfg.cfar1d, ts))(x)
    assert [r["hits"] for r in rep["sim_2d"]] == np.asarray(c2).tolist()
    assert [r["hits"] for r in rep["realdata_1d"]] == np.asarray(c1).tolist()
    assert (rep["cells_2d"], rep["cells_1d"]) == (int(n2), int(n1))


def test_studies_find_their_truths(reports):
    rf = reports["roc_full"]
    assert rf["t_factors"] == _artifact("roc_full.json")["t_factors"]
    assert rf["pd"][0] == 1.0 and len(rf["pd_ci95"]) == 9
    assert "HEADLINE:" in reports["stdout"]
    ab = reports["ab"]
    assert all(r["count_delta"] == 0
               for sec in ("exponential_validation", "sim_path_operating")
               for r in ab[sec]["rows"])
    assert ab["sim_path_operating"]["t8_hits_shift"] == 0
    mono = reports["mono"]
    assert [d["snr_db"] for d in mono["deltas"]] == [0.0, 20.0]
    assert all(r["pd"] == 1.0 for r in mono["rows"])
    cost = mono["e2e_cost"]
    assert cost["ms_per_frame_integer"] > 0 and cost["relative"] > 0


SCRIPTS = [run_roc, run_pfa, run_roc_full, run_pfa_means_ab,
           run_monopulse_ab]


@pytest.mark.parametrize("idx", range(len(SCRIPTS)))
def test_scripts_refuse_a_missing_card(idx, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        SCRIPTS[idx].main(["--out", str(tmp_path / "never.json")])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("script", [run_roc, run_roc_full])
def test_a_png_without_matplotlib_exits_first(script, tmp_path,
                                              monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        script.main(["--cpu", "--out", str(tmp_path / "r.json"), "--png",
                     str(tmp_path / "r.png")])
    assert not os.listdir(tmp_path)


def test_the_png_is_drawn_when_asked(reports, tmp_path):
    for script, name in ((run_roc, "roc"), (run_roc_full, "roc_full")):
        path = str(tmp_path / f"{name}.png")
        script.plot(reports[name], path)
        assert os.path.getsize(path) > 2000, name


def test_run_roc_full_takes_a_scaled_geometry(tmp_path):
    """``--channels/--pulses/--truth-el``: the BASELINE geometry's flags,
    here at 16 channels x 64 pulses."""
    rep = run_roc_full.main(["--cpu", "--channels", "16", "--pulses", "64",
                             "--truth-el=10", "--snr=0", "--trials", "1",
                             "--noise-frames", "1", "--out",
                             str(tmp_path / "r.json")])
    assert rep["config"].startswith("16ch x 64p scaled")
    assert rep["truth_elevation_deg"] == 10.0 and rep["pd"][0] == 1.0
