"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries go to ``build/radar_tpu_torch/`` at the
repository root, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused. Nothing is compiled at
import time; the first kernel call builds, and ``build_all`` compiles
several sources at once, one ``nvcc`` process each.

Host C++ sources (``csrc/<name>.cpp``: the track associator) are compiled
the same way by ``load_host``, with the host compiler ``c++``; a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "radar_tpu_torch")

_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# K2, K3 and K5 must match their plain versions' rounding: no FMA
# contraction; the noise-RDM kernels are held by RMS-relative bounds and
# may contract
_EXTRA = {"noise_rdm": [], "noise_rdm_sm90": [], "rdm_variants": [],
          "band_pc_sm90": [], "rdm_sm90": [],
          "cfar": ["-fmad=false"], "awgn": ["-fmad=false"], "ring": []}

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_F, _LL = ctypes.c_float, ctypes.c_longlong
_ULL = ctypes.c_ulonglong
_SIGNATURES = {
    "noise_rdm": {
        "k1c_planes": [_P, _I, _U, _U, _F, _I, _I, _P, _P],
    },
    "noise_rdm_sm90": {
        "k1_tf32_pc": [_I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
        "k4_tf32_pc": [_I, _P, _I, _I, _I, _I, _I, _U, _U, _F, _P, _P, _P,
                       _P, _P],
        "k8_tf32_pc": [_I, _P, _I, _I, _P, _P],
        "k1_tf32_mix": [_P, _P, _P, _P, _P, _I, _LL, _P],
        "k1_tf32_dft": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I,
                        _P, _I, _P, _P, _P, _LL, _LL, _P],
    },
    "rdm_variants": {
        "rv_mix": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P],
    },
    "rdm_sm90": {
        "rs_dft": [_P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P],
    },
    "band_pc_sm90": {
        "sp_band_pc": [_I, _P, _I, _I, _I, _P, _P, _P, _P],
        "sp_band_pc_draw": [_I, _P, _I, _I, _I, _U, _U, _F, _P, _P, _P],
        "sp_stage": [_P, _LL, _I, _I, _P, _I, _P, _I, _P],
    },
    "cfar": {
        "k2_cfar": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                    _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
        "k3_cfar": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I,
                    _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    },
    "awgn": {
        "k5_awgn": [_P, _P, _LL, _U, _U, _F, _F, _P],
    },
    "ring": {
        "k6_handle_bytes": [],
        "k6_alloc": [_I, _LL, _P, _P, _P],
        "k6_open": [_I, _P, _P],
        "k6_close": [_P],
        "k6_free": [_P, _P],
        "k6_blocks": [_I, _I, _P],
        "k6_push": [_P, _LL, _I, _LL, _P, _LL, _LL, _I, _ULL, _LL, _P, _P,
                    _I, _I, _P],
        "k6_fill": [_P, _LL, _LL, _I, _P, _LL, _LL, _LL, _ULL, _LL, _P, _I,
                    _I, _P],
    },
}

_libs: dict = {}
# name -> {"seconds": build time (0 when reused), "log": nvcc output}
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> tuple[str, str, list]:
    src = os.path.join(_CSRC, name + ".cu")
    flags = _COMMON + _EXTRA[name]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    return src, out, flags


def build_all(names) -> None:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all running at once; then load them."""
    started = []
    for name in names:
        if name in _libs:
            continue
        src, out, flags = _library_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *flags, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((name, src, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, out, tmp, proc, t0 in started:
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        load(name)


def load(name: str) -> ctypes.CDLL:
    """The compiled library ``name`` (building it on first use)."""
    if name in _libs:
        return _libs[name]
    _, out, _ = _library_path(name)
    if not os.path.exists(out):
        build_all([name])
        return _libs[name]
    build_info.setdefault(name, {"seconds": 0.0, "log": ""})
    lib = ctypes.CDLL(out)
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.radar_error_string.argtypes = [ctypes.c_int]
    lib.radar_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


# no -march=native: a cached library must run on any x86-64 host
_HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]


def load_host(name: str) -> ctypes.CDLL:
    """The host library of ``csrc/<name>.cpp``, compiled with ``c++`` at
    first use into ``BUILD_DIR`` (named by a hash of the source and
    flags). Raises with the compiler's message if it cannot be built or
    loaded; there is no fallback."""
    if name in _libs:
        return _libs[name]
    src = os.path.join(_CSRC, name + ".cpp")
    digest = hashlib.sha256(" ".join(_HOST_FLAGS).encode())
    with open(src, "rb") as f:
        digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        cxx = shutil.which("c++")
        if cxx is None:
            raise RuntimeError(f"no host C++ compiler (c++) to build {src}")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *_HOST_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            "log": proc.stdout + proc.stderr}
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"c++ failed on {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    build_info.setdefault(name, {"seconds": 0.0, "log": ""})
    _libs[name] = ctypes.CDLL(out)
    return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.radar_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
