"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

One binding for every kernel module (``warp_kernels``, ``crf_kernels``,
``attention_kernels``): each holds one ``Library``. ``nvcc`` compiles the
module's sources for ``sm_90a`` into a shared library with a plain C
interface, under ``rcf_tpu_torch/build/``, named by the module's stem and a
hash of the sources and flags, at the first launch. No PyTorch headers, no
ninja: a few seconds a library. ``ctypes`` loads it; a C entry point takes
device pointers and the stream, launches, and returns ``cudaGetLastError()``,
which ``Library.launch`` raises on.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda)")


def ptxas_entries(so: str) -> list[dict]:
    """Registers, spill bytes and static shared memory of each kernel instance
    (``entry``: its mangled name), from the compiler's log beside ``so``."""
    rows, cur = [], None
    with open(so[:-3] + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = {"entry": m.group(1)}
                rows.append(cur)
            elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, "
                                                      r"(\d+) bytes spill loads", line)):
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
                cur["registers"] = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = int(smem.group(1)) if smem else 0
    return rows


def check_device(name: str, *ts: torch.Tensor) -> str:
    """The one device type of ``ts`` ("cpu" or "cuda"); raises on a mix or another type."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


class Library:
    """The shared library of ``sources`` (in ``csrc/``), built at its first launch.

    ``entry_points`` maps each C entry point to its ``argtypes`` (the stream
    last); each returns the CUDA error as an int. ``launches`` counts the
    launches of each name in ``kernels``. ``using`` and ``patched`` send the
    launches through another build for the length of a ``with`` block (a test
    build, a planted fault, a design variant).
    """

    def __init__(self, stem: str, sources: tuple, entry_points: dict, kernels: tuple):
        self.stem, self.sources, self.entry_points = stem, tuple(sources), dict(entry_points)
        self.launches = dict.fromkeys(kernels, 0)
        self._lib = None

    def reset(self) -> None:
        for k in self.launches:
            self.launches[k] = 0

    def build(self, csrc_dir: str = CSRC_DIR) -> str:
        """Compile the sources if this hash has not been built; returns the .so path.

        ``csrc_dir`` may name another copy of the sources (it enters the hash
        through their text). The compiler's report (``-Xptxas -v``: registers,
        spills) is kept beside the library as ``<name>.log``.
        """
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in self.sources:
            with open(os.path.join(csrc_dir, name), "rb") as f:
                h.update(f.read())
        so = os.path.join(BUILD_DIR, f"{self.stem}_{h.hexdigest()[:16]}.so")
        if os.path.isfile(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(csrc_dir, s) for s in self.sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(so[:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
        return so

    def build_patched(self, replacements, tag: str) -> str:
        """Build a changed copy of the sources: each (old, new) pair replaces text
        that occurs exactly once. The copy lives in ``build/<tag>/``; returns the
        .so path."""
        texts = {}
        for name in self.sources:
            with open(os.path.join(CSRC_DIR, name)) as f:
                texts[name] = f.read()
        for old, new in replacements:
            sites = [n for n, t in texts.items() for _ in range(t.count(old))]
            if len(sites) != 1:
                raise ValueError(f"{old!r} does not occur exactly once in {self.sources}")
            texts[sites[0]] = texts[sites[0]].replace(old, new)
        src_dir = os.path.join(BUILD_DIR, tag)
        os.makedirs(src_dir, exist_ok=True)
        for name, text in texts.items():
            with open(os.path.join(src_dir, name), "w") as f:
                f.write(text)
        return self.build(src_dir)

    def load(self, path: str) -> ctypes.CDLL:
        """Load a built library and declare its entry points."""
        lib = ctypes.CDLL(path)
        for name, argtypes in self.entry_points.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return lib

    def ptxas(self) -> list[dict]:
        """``ptxas_entries`` of the release build."""
        return ptxas_entries(self.build())

    @contextlib.contextmanager
    def using(self, lib):
        """Launch through ``lib`` (any object with the entry points) inside the
        block; the library in use before comes back on exit."""
        before, self._lib = self._lib, lib
        try:
            yield lib
        finally:
            self._lib = before

    @contextlib.contextmanager
    def patched(self, replacements, tag: str):
        """``using`` a build of ``build_patched(replacements, tag)``; yields it."""
        with self.using(self.load(self.build_patched(replacements, tag))) as lib:
            yield lib

    def launch(self, name: str, entry: str, dev: torch.device, *args) -> None:
        """Call the C entry point ``entry`` on ``dev``'s current stream, with ``dev``
        the current device, and add one to ``launches[name]``. The device guard and
        the raw stream handle cost the host about a tenth of ``torch.cuda.device``
        and ``torch.cuda.current_stream`` (PERF.md): a wrapper's host time per call
        then stays under the warps' device time at the step's level 0."""
        if self._lib is None:
            self._lib = self.load(self.build())
        fn = getattr(self._lib, entry)
        with torch.cuda._DeviceGuard(dev.index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
        if err != 0:
            raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
        self.launches[name] += 1
