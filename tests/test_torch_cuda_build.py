"""The kernel libraries' bindings (``rcf_tpu_torch/ops/cuda_build.py``), on the CPU.

ctypes calls an entry point with the argument list its ``Library`` declares
and no check against the C definition: a wrong list corrupts memory
silently. Each library's declared entry points must equal the functions its
sources define with C linkage, by name and by the ctypes type of each
parameter (a pointer, ``int64_t``, ``int``).
"""

from __future__ import annotations

import ctypes
import os
import re

import pytest

from rcf_tpu_torch.ops import attention_kernels, crf_kernels, linear_kernels, warp_kernels


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    if "int64_t" in param:
        return ctypes.c_int64
    if param.split()[0] == "int":
        return ctypes.c_int
    raise ValueError(f"no ctypes type for the parameter {param!r}")


def _extern_c(src: str) -> dict:
    """name -> parameter types of each function ``src`` defines with C linkage:
    ``extern "C" int f(...)`` and each ``int f(...)`` inside ``extern "C" { ... }``."""
    heads = re.findall(r'extern "C" (int \w+\([^)]*\))', src)
    for m in re.finditer(r'extern "C" \{', src):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        heads += re.findall(r"^int \w+\([^)]*\)", src[m.end():i], re.M)
    out = {}
    for head in heads:
        name, params = re.match(r"int (\w+)\(([^)]*)\)", head).groups()
        out[name] = [_ctype(p) for p in params.split(",")]
    return out


@pytest.mark.parametrize("module", [warp_kernels, crf_kernels, attention_kernels, linear_kernels],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_declared_entry_points_are_the_sources_c_functions(module):
    src = ""
    for name in module.LIB.sources:
        with open(os.path.join(module.CSRC_DIR, name)) as f:
            src += f.read()
    declared = {name: list(argtypes) for name, argtypes in module.LIB.entry_points.items()}
    assert declared == _extern_c(src)
