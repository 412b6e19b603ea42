"""PyTorch port: the tracking Monte-Carlo entry point
(``python -m radar_tpu_torch.scripts.run_tracking_mc``), modelled on
``tests/test_tracking_scripts.py:46``: a tiny CPU run writes the JAX
script's JSON keys and loads no JAX; its scenes are the JAX script's,
draw for draw."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from radar_tpu.config import params as jparams

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.scripts import run_tracking_mc as port_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_run_tracking_mc", os.path.join(REPO, "scripts",
                                            "run_tracking_mc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tracking_mc_smoke(tmp_path):
    out = tmp_path / "mc.json"
    code = ("import runpy, sys; "
            "sys.argv = ['run_tracking_mc'] + sys.argv[1:]; "
            "runpy.run_module('radar_tpu_torch.scripts.run_tracking_mc', "
            "run_name='__main__'); "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'radar_tpu' or m.startswith('radar_tpu.') "
            "for m in sys.modules), 'radar_tpu imported'")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--device", "cpu", "--small",
         "--scenes", "3", "--frames", "8", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    rep = json.loads(out.read_text())
    assert set(rep) == {"what", "device", "config", "scenes",
                        "frames_per_scene", "wall_s", "overall",
                        "by_scene_type", "match_gates"}
    assert rep["device"] == "cpu"
    assert rep["scenes"] == 3 and rep["frames_per_scene"] == 8
    assert rep["config"] == {"channels": 8, "pulses": 32, "seed": 0,
                             "path": "perf", "stage2_vel_gate": None}
    assert set(rep["by_scene_type"]) == {"random", "close", "crossing"}
    ov = rep["overall"]
    assert set(ov) == {"scenes", "track_pd", "false_tracks_per_scene",
                       "ghost_tracks_per_scene", "fragmentation",
                       "switched_tracks_total", "mean_purity",
                       "mean_coverage_detected"}
    assert 0.0 <= ov["track_pd"] <= 1.0 and ov["scenes"] == 3
    assert "scene 3/3 [crossing]" in proc.stdout


@pytest.mark.parametrize("config", ["small", "full"])
def test_scenes_match_the_jax_script(config):
    jscript = _jax_script()
    make = "small_test_config" if config == "small" else "full_config"
    jcfg, tcfg = getattr(jparams, make)(), getattr(tparams, make)()
    for s, stype in enumerate(port_script.SCENE_TYPES * 2):
        el_range = None if s < 3 else (-16.0, 3.2)
        want = jscript.make_scene(np.random.default_rng(1000 + s), jcfg,
                                  stype, 40, el_range)
        got = port_script.make_scene(np.random.default_rng(1000 + s), tcfg,
                                     stype, 40, el_range)
        for f in got._fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{stype} {f}")
    assert port_script.SCENE_TYPES == jscript.SCENE_TYPES
