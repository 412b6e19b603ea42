"""PyTorch port: ``viz/plots.py`` held against the JAX package's. Every
plot renders on ``tests/test_viz.py``'s inputs (and the empty ones), and
the data each figure plots — line x/y, scatter offsets, sizes and colour
values, filled-band vertices, image arrays, titles and labels, captured
before saving — equals JAX's figure for the same inputs (rtol 1e-6; the
smoothed tracks come from each package's own smoother, rtol 1e-5). Without
matplotlib the module still imports and a call exits naming it."""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from radar_tpu.config.params import small_test_config as j_small  # noqa: E402
from radar_tpu.pipeline import driver as jdriver  # noqa: E402
from radar_tpu.pipeline.montecarlo import SweepResult as JSweep  # noqa: E402
from radar_tpu.pipeline.tracking import smooth_tracks as j_smooth  # noqa
from radar_tpu.viz import plots as jplots  # noqa: E402
from radar_tpu.waveform.precompute import precompute as j_precompute  # noqa

from radar_tpu_torch.config.params import small_test_config  # noqa: E402
from radar_tpu_torch.pipeline import driver as tdriver  # noqa: E402
from radar_tpu_torch.pipeline.montecarlo import SweepResult  # noqa: E402
from radar_tpu_torch.pipeline.tracking import smooth_tracks  # noqa: E402
from radar_tpu_torch.viz import plots as tplots  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tracks(mod):
    return [mod.Track(3000.0, 10.0, 12.0, 45.0, 5.0, 1, 6, 6, np.arange(3)),
            mod.Track(8000.0, -5.0, 20.0, 100.0, 2.0, 2, 4, 2,
                      np.array([3, 4]))]


def _log(mod):
    n = 5
    return mod.DetectionLog(
        range_m=np.linspace(3000, 3010, n),
        velocity_ms=np.full(n, 10.0),
        elevation_deg=np.full(n, 12.0),
        power=np.linspace(1, 2, n),
        frame=np.arange(1, n + 1),
        azimuth_deg=np.linspace(44, 46, n))


def _sweep(cls):
    return cls(np.array([-10.0, 0.0, 10.0]), np.array([2.0, 1.0, 0.3]),
               np.array([0.1, 0.7, 1.0]), np.zeros((3, 4)),
               np.array([3.0, 1.0, 0.3]))


def _track_log(mod, n=8):
    """A straight track over ``n`` frames (the smoother's input)."""
    f = np.arange(1, n + 1)
    return (mod.DetectionLog(
        range_m=3000.0 - 6.0 * f + np.sin(f), velocity_ms=np.full(n, 10.0),
        elevation_deg=12.0 + 0.01 * f, power=np.linspace(1, 2, n), frame=f,
        azimuth_deg=np.linspace(44, 46, n)),
        [mod.Track(2990.0, 10.0, 12.0, 45.0, 2.0, 1, n, n, np.arange(n))])


@functools.lru_cache(maxsize=1)
def _cases():
    """(name, JAX call, port call): each takes the output path. The port
    gets tensors where it can take them."""
    jcfg = j_small()
    jpre = j_precompute(jcfg)
    rng = np.random.default_rng(0)
    rdm = rng.normal(size=(32, 200)) + 1j * rng.normal(size=(32, 200))
    rax, vax = jpre.range_axis[:200], jpre.velocity_axis
    jl, tl = _log(jdriver), _log(tdriver)
    jt, tt = _tracks(jdriver), _tracks(tdriver)
    jsl, jst = _track_log(jdriver)
    tsl, tst = _track_log(tdriver)
    cfg = small_test_config()
    lam = jcfg.sig.wavelength
    spacing = jcfg.array.element_spacing
    return [
        ("ppi", lambda p: jplots.plot_ppi(jt, p),
         lambda p: tplots.plot_ppi(tt, p)),
        ("ppi_title", lambda p: jplots.plot_ppi(jt, p, title="T"),
         lambda p: tplots.plot_ppi(tt, p, title="T")),
        ("rhi", lambda p: jplots.plot_rhi(jt, p),
         lambda p: tplots.plot_rhi(tt, p)),
        ("rdm", lambda p: jplots.plot_rdm(rdm, rax, vax, p,
                                          truth_ranges=[500.0]),
         lambda p: tplots.plot_rdm(torch.from_numpy(rdm),
                                   torch.from_numpy(rax), vax, p,
                                   truth_ranges=torch.tensor([500.0]))),
        ("pc", lambda p: jplots.plot_pc_profile(rdm[0], rax, p,
                                                truth_ranges=[500.0]),
         lambda p: tplots.plot_pc_profile(torch.from_numpy(rdm[0]), rax, p,
                                          truth_ranges=[500.0])),
        ("history", lambda p: jplots.plot_track_history(jl, jt, p),
         lambda p: tplots.plot_track_history(tl, tt, p)),
        ("clusters", lambda p: jplots.plot_cluster_comparison(jl, jt, p),
         lambda p: tplots.plot_cluster_comparison(tl, tt, p)),
        ("beams", lambda p: jplots.plot_beam_patterns_fig(
            jpre.dbf_w, spacing, lam, p),
         lambda p: tplots.plot_beam_patterns_fig(
             torch.from_numpy(np.asarray(jpre.dbf_w)), spacing, lam, p)),
        ("sweep", lambda p: jplots.plot_snr_sweep(_sweep(JSweep), p),
         lambda p: tplots.plot_snr_sweep(_sweep(SweepResult), p)),
        ("smoothed", lambda p: jplots.plot_smoothed_tracks(
            j_smooth(jsl, jst, jcfg), p),
         lambda p: tplots.plot_smoothed_tracks(smooth_tracks(tsl, tst, cfg),
                                               p)),
    ]


def _fig_data(fig) -> list:
    """What a figure plots, axis by axis (colour bars included)."""
    out = []
    for ax in fig.axes:
        out.append({
            "text": (ax.get_title(), ax.get_xlabel(), ax.get_ylabel()),
            "lines": [np.asarray(ln.get_xydata()) for ln in ax.get_lines()],
            "offsets": [np.asarray(c.get_offsets()) for c in ax.collections],
            "sizes": [np.asarray(c.get_sizes()) for c in ax.collections
                      if hasattr(c, "get_sizes")],
            "values": [np.asarray(c.get_array()) for c in ax.collections
                       if c.get_array() is not None],
            "paths": [np.asarray(p.vertices) for c in ax.collections
                      for p in c.get_paths()],
            "images": [np.asarray(im.get_array()) for im in ax.get_images()],
            "ylim": ax.get_ylim() if ax.name != "polar" else None,
        })
    return out


def _capture(module, monkeypatch, call) -> list:
    """The data of the figure ``call`` draws, taken before saving."""
    figs = []
    monkeypatch.setattr(module, "_save", lambda fig, path: (
        figs.append(fig), path)[1])
    call("unused.png")
    monkeypatch.undo()
    assert len(figs) == 1
    data = _fig_data(figs[0])
    plt.close("all")
    return data


def _same(got, want, rtol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b, rtol)
    elif isinstance(want, str) or want is None:
        assert got == want
    else:
        np.testing.assert_allclose(np.asarray(got, float),
                                   np.asarray(want, float), rtol=rtol,
                                   atol=0)


@pytest.mark.parametrize("idx", range(10))
def test_plot_data_matches_jax(idx, monkeypatch, tmp_path):
    name, jcall, tcall = _cases()[idx]
    want = _capture(jplots, monkeypatch, jcall)
    got = _capture(tplots, monkeypatch, tcall)
    _same(got, want, 1e-5 if name == "smoothed" else 1e-6)
    path = tcall(str(tmp_path / "sub" / f"{name}.png"))
    assert os.path.getsize(path) > 2000, name


def test_empty_inputs_render(tmp_path):
    empty = tdriver.DetectionLog.empty()
    paths = [tplots.plot_ppi([], str(tmp_path / "ppi.png")),
             tplots.plot_rhi([], str(tmp_path / "rhi.png")),
             tplots.plot_track_history(empty, [], str(tmp_path / "h.png")),
             tplots.plot_cluster_comparison(empty, [],
                                            str(tmp_path / "c.png")),
             tplots.plot_smoothed_tracks([], str(tmp_path / "s.png"))]
    for p in paths:
        assert os.path.getsize(p) > 1000, p


def test_without_matplotlib_the_module_imports_and_a_call_exits():
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import radar_tpu_torch.viz as v\n"
            "try:\n"
            "    v.plot_ppi([], 'never.png')\n"
            "except SystemExit as e:\n"
            "    assert 'matplotlib' in str(e), e\n"
            "else:\n"
            "    raise AssertionError('drew without matplotlib')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert not os.path.exists(os.path.join(REPO, "never.png"))
