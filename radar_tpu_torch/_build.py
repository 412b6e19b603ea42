"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries go to ``build/radar_tpu_torch/`` at the
repository root, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused. Nothing is compiled at
import time; the first kernel call builds.
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
# K2's mask must be bit-identical to the plain version: no FMA contraction
_EXTRA = {"noise_rdm": [], "cfar": ["-fmad=false"]}

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_F, _LL = ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "noise_rdm": {
        "k1_pc": [_P, _I, _I, _I, _I, _I, _U, _U, _F, _P, _P, _LL, _I, _I,
                  _I, _P, _P],
        "k1_mix": [_P, _P, _I, _LL, _P],
        "k1_mtd": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P],
    },
    "cfar": {
        "k2_cfar": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                    _I, _P, _P, _P],
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


def load(name: str) -> ctypes.CDLL:
    """The compiled library ``name`` (building it on first use)."""
    if name in _libs:
        return _libs[name]
    src = os.path.join(_CSRC, name + ".cu")
    flags = _COMMON + _EXTRA[name]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
    lib = ctypes.CDLL(out)
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.radar_error_string.argtypes = [ctypes.c_int]
    lib.radar_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.radar_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
