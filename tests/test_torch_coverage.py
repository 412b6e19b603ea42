"""PyTorch port: the port covers the JAX package name by name.

Both trees are read with ``ast``; neither is imported. For every
``radar_tpu/**.py``, each public top-level function and class has a
counterpart of the same name in the port file at the same path
(``radar_tpu_torch/...``), but for the exceptions of ``EXCEPTIONS``, each
with its reason. The ``pl.pallas_call`` sites under ``radar_tpu/`` are
exactly the TPU kernels of ``KERNELS``, each with its hand-written CUDA
source in ``radar_tpu_torch/csrc/`` and its wrapper in the port, so a new
TPU kernel cannot go unported without a test saying so.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX = REPO / "radar_tpu"
PORT = REPO / "radar_tpu_torch"

# JAX file -> (port file or None, {JAX name: port name, None where the
# port has none}, reason). A port file of None: the whole file has no
# counterpart of its own.
EXCEPTIONS = {
    "ops/pallas_kernels.py": (
        None, {}, "the TPU kernels K2 and K3 became csrc/cfar.cu behind "
        "ops/cfar_kernel.py (goca_cfar_qvg, goca_cfar_2d_fused, "
        "pad_maps_qvg)"),
    "ops/pallas_noise.py": (
        None, {}, "the TPU kernel K5 became csrc/awgn.cu behind ops/awgn.py"),
    "ops/pallas_rdm.py": (
        None, {}, "the TPU kernels K1, K4, K7, K9, K10 and K1c became "
        "csrc/noise_rdm.cu, noise_rdm_sm90.cu, band_pc_sm90.cu, rdm_sm90.cu "
        "and rdm_variants.cu behind ops/noise_rdm.py (RdmPlan, "
        "make_rdm_plan, noise_rdm, noise_rdm_compact, gen_noise_planes)"),
    "parallel/mesh.py": (
        "parallel/mesh.py", {"replicated": None, "spec": None},
        "they build JAX NamedShardings; the port's Mesh places no arrays "
        "(radar_tpu_torch/parallel/mesh.py's docstring)"),
    "parallel/pallas_ring.py": (
        "parallel/pallas_ring.py", {"halo_exchange_complex": None},
        "K6 fills the overlap-save FFT input itself (RangeShardedPC); "
        "halo_right_permute and halo_right_plain give the halo alone"),
    "native/__init__.py": (
        "native.py", {"available": None, "binio_available": None},
        "they report JAX's numpy fallback; the port has no fallback (its "
        "host C++ builds at first use or raises)"),
    "studies/pallas_pc.py": (
        "studies/pallas_pc.py",
        {"pulse_compress_noise_pallas": "pulse_compress_noise"},
        "the TPU kernel K8's wrapper; the port's takes its plan and dtype "
        "and launches csrc/band_pc_sm90.cu"),
}

# (kernel, JAX file, top-level function holding the pl.pallas_call, port
# wrapper "module::function", port CUDA sources). Rows 1 and 2 share a
# call site: K4 is noise_rdm_pallas_gen(rolling=False).
KERNELS = [
    ("K1", "ops/pallas_rdm.py", "noise_rdm_pallas_gen",
     "ops/noise_rdm.py::noise_rdm",
     ("noise_rdm.cu", "noise_rdm_sm90.cu", "band_pc_sm90.cu", "rdm_sm90.cu",
      "rdm_variants.cu")),
    ("K4", "ops/pallas_rdm.py", "noise_rdm_pallas_gen",
     "ops/noise_rdm.py::noise_rdm", ("noise_rdm_sm90.cu", "band_pc_sm90.cu")),
    ("K1 planes mode, K10", "ops/pallas_rdm.py", "noise_rdm_pallas_planes",
     "ops/noise_rdm.py::noise_rdm_compact",
     ("noise_rdm_sm90.cu", "band_pc_sm90.cu", "rdm_sm90.cu",
      "rdm_variants.cu")),
    ("K7", "ops/pallas_rdm.py", "_call_stacked",
     "ops/noise_rdm.py::noise_rdm_compact",
     ("noise_rdm_sm90.cu", "band_pc_sm90.cu", "rdm_sm90.cu",
      "rdm_variants.cu")),
    ("K9", "ops/pallas_rdm.py", "_call_allbeams",
     "ops/noise_rdm.py::noise_rdm_compact",
     ("noise_rdm_sm90.cu", "band_pc_sm90.cu", "rdm_sm90.cu",
      "rdm_variants.cu")),
    ("K1c", "ops/pallas_rdm.py", "gen_noise_planes_pallas",
     "ops/noise_rdm.py::gen_noise_planes", ("noise_rdm.cu",)),
    ("K2", "ops/pallas_kernels.py", "goca_cfar_qvg_pallas",
     "ops/cfar_kernel.py::goca_cfar_qvg", ("cfar.cu",)),
    ("K3", "ops/pallas_kernels.py", "goca_cfar_2d_pallas",
     "ops/cfar_kernel.py::goca_cfar_2d_fused", ("cfar.cu",)),
    ("K5", "ops/pallas_noise.py", "add_noise_pallas", "ops/awgn.py::awgn",
     ("awgn.cu",)),
    ("K6", "parallel/pallas_ring.py", "halo_right_permute",
     "parallel/pallas_ring.py::halo_right_permute", ("ring.cu",)),
    ("K8", "studies/pallas_pc.py", "pulse_compress_noise_pallas",
     "studies/pallas_pc.py::pulse_compress_noise",
     ("band_pc_sm90.cu", "noise_rdm_sm90.cu")),
]

JAX_FILES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _public(path: pathlib.Path) -> set:
    """Public top-level functions and classes of a source file."""
    return {n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")}


def _top_level(path: pathlib.Path) -> dict:
    return {n.name: n for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


def _pallas_sites() -> list:
    """(JAX file, top-level function) of every ``pallas_call`` call."""
    sites = []
    for rel in JAX_FILES:
        for node in _tree(JAX / rel).body:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and (
                        getattr(sub.func, "attr", None) == "pallas_call"
                        or getattr(sub.func, "id", None) == "pallas_call"):
                    sites.append((rel, getattr(node, "name", None)))
    return sites


@pytest.mark.parametrize("rel", JAX_FILES)
def test_port_has_every_public_name(rel):
    port_rel, renamed, why = EXCEPTIONS.get(rel, (rel, {}, None))
    names = _public(JAX / rel)
    if port_rel is None:
        # the whole file is excepted: it holds TPU kernels (KERNELS) and
        # has no port file of its own
        assert not (PORT / rel).exists(), (rel, why)
        assert any(f == rel for _, f, *_ in KERNELS), (rel, why)
        return
    assert (PORT / port_rel).exists(), f"no port file {port_rel} for {rel}"
    have = _public(PORT / port_rel)
    for jname, pname in renamed.items():
        # every exception is still needed and still true
        assert jname in names, f"stale exception {rel}::{jname}"
        assert jname not in have, f"{port_rel} now has {jname}: drop it"
        if pname is not None:
            assert pname in have, f"{port_rel} lacks {pname} ({why})"
    missing = sorted(names - have - set(renamed))
    assert not missing, f"{port_rel} lacks {missing} of {rel}"


def test_pallas_call_sites_are_the_kernel_table():
    sites = _pallas_sites()
    assert len(KERNELS) == 11
    assert sorted(set(sites)) == sorted({(f, fn) for _, f, fn, *_ in
                                         KERNELS})
    # one call site per function but K1/K4's, whose modes share it
    assert len(sites) == 10
    gen = _top_level(JAX / "ops/pallas_rdm.py")["noise_rdm_pallas_gen"]
    assert "rolling" in [a.arg for a in gen.args.args]


@pytest.mark.parametrize("row", KERNELS, ids=[k[0] for k in KERNELS])
def test_every_tpu_kernel_has_a_cuda_port(row):
    _, jax_file, fn, wrapper, sources = row
    assert fn in _top_level(JAX / jax_file)
    module, func = wrapper.split("::")
    assert func in _top_level(PORT / module), wrapper
    for src in sources:
        assert (PORT / "csrc" / src).is_file(), src
