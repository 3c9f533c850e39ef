"""ctypes bridge to the host permutohedral dense CRF (port of ``rcf_tpu/ops/crf_native.py``).

``native/crf/permutohedral_crf.cpp`` is an O(N) C++ mean field (binary
labels, a lattice-approximated normalized Gaussian filter) for
full-resolution post-processing and pseudo-labels on the host. The port
compiles that source itself at first use with the host compiler (``CXX``,
else ``g++``) and ``native/Makefile``'s flags, into
``rcf_tpu_torch/build/libpermutohedral_crf_<hash>.so`` (named by a hash of
the compiler, the flags and the source), so that the port's library and
the JAX package's give the same bits on one machine. A failed build raises:
no caller falls back to another engine. The call releases the GIL, so
threads run frames in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "crf", "permutohedral_crf.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path(cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpermutohedral_crf_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the lattice if this compiler, flags and source have not been built;
    returns the .so path."""
    cxx = compiler()
    so = library_path(cxx)
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                              text=True)
    except OSError as exc:
        raise RuntimeError(f"building the native CRF with {cxx} failed: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"building the native CRF with {cxx} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    """The library of the current compiler, built at its first use."""
    cxx = compiler()
    with _lock:
        if cxx not in _libs:
            lib = ctypes.CDLL(build())
            f, i, p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
            lib.rcf_crf_soft.restype = None
            lib.rcf_crf_soft.argtypes = [p, p, i, i, f, f, f, f, f, i, f, p]
            _libs[cxx] = lib
        return _libs[cxx]


def crf_soft_native(rgb_u8: np.ndarray, mask01: np.ndarray, srgb: float = 5.0,
                    scomp: float = 5.0, sxy: float = 60.0, scomp_smooth: float = 0.0,
                    sxy_smooth: float = 0.0, refine_iters: int = 50,
                    crf_scale: float = 0.7) -> np.ndarray:
    """[H, W, 3] uint8 + [H, W] float mask -> [H, W] binary refined mask, f32."""
    h, w = mask01.shape
    if rgb_u8.shape != (h, w, 3):
        raise ValueError(f"rgb {rgb_u8.shape} does not match mask {mask01.shape}")
    lib = _load()
    rgb_c = np.ascontiguousarray(rgb_u8, dtype=np.uint8)
    mask_c = np.ascontiguousarray(mask01, dtype=np.float32)
    out = np.empty((h, w), np.float32)
    lib.rcf_crf_soft(rgb_c.ctypes.data, mask_c.ctypes.data, h, w, scomp_smooth, sxy_smooth,
                     scomp, sxy, srgb, int(refine_iters), crf_scale, out.ctypes.data)
    return out
