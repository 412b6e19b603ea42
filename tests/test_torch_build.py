"""The ctypes argument table of ``radar_tpu_torch/_build.py`` against the C
entry points of each CUDA source: every ``extern "C"`` function a library
exports is in the table, with one ctypes type per parameter, of the C
parameter's type. (A missing or mistyped entry only shows on the card, as a
wrong value passed through ctypes.)"""

import ctypes
import os
import re

import pytest

from radar_tpu_torch import _build

_C_TYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
            "float": ctypes.c_float, "long long": ctypes.c_longlong,
            "unsigned long long": ctypes.c_ulonglong}


def _entries(name: str) -> dict:
    """name -> [ctypes type of each parameter] of the functions defined
    after the first ``extern "C"`` of csrc/<name>.cu."""
    with open(os.path.join(_build._CSRC, name + ".cu")) as f:
        text = f.read()
    text = text[text.index('extern "C"'):]
    out = {}
    for m in re.finditer(r"^(?:const )?\w+\**\s+\**(\w+)\(([^)]*)\)\s*\{",
                         text, re.M):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        types = []
        for p in params:
            if "*" in p:
                types.append(ctypes.c_void_p)
            else:
                base = " ".join(p.replace("const ", "").split()[:-1])
                types.append(_C_TYPES[base])
        out[m.group(1)] = types
    return out


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_argtypes_match_the_c_entries(name):
    entries = _entries(name)
    assert entries.pop("radar_error_string") == [ctypes.c_int]
    assert set(entries) == set(_build._SIGNATURES[name])
    for fn, types in entries.items():
        assert _build._SIGNATURES[name][fn] == types, fn
