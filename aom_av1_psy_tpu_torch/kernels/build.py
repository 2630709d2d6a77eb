"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Route: ``nvcc`` compiles each ``csrc/<name>.cu`` (a plain C interface, no
PyTorch headers) into ``build/aom_av1_psy_tpu_torch/lib<name>.so`` at first
use, and ``ctypes`` loads it. A library is rebuilt when its source or the
shared header is newer (the same rule as the native range coder's build).
Pointers come from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``. Every C entry point launches on
that stream, does not synchronise, and returns ``cudaGetLastError()``;
``CudaKernel.launch`` raises on a non-zero code.

``-O3 --fmad=false``: the RD arithmetic next to the kernels is float32 and
decides modes, so ``a*b+c`` must round twice as it does in the JAX
reference, never once as an FMA.
"""
from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "aom_av1_psy_tpu_torch")
_COMMON = os.path.join(CSRC, "common.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def nvcc_path() -> str:
    p = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(p):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ on a machine with the CUDA toolkit")
    return p


class CudaKernel:
    """One ``csrc/<name>.cu`` library.

    ``entry_points`` maps each C function to its ctypes argument types (the
    stream is the last argument of every one). ``launches`` counts the
    kernel launches made through :meth:`launch`; ``variants`` counts them
    again by the label the wrapper passes (block size, mode), so a caller
    can tell which instance of a kernel ran."""

    def __init__(self, name: str, entry_points: dict):
        self.name = name
        self.entry_points = entry_points
        self.launches = 0
        self.variants = collections.Counter()
        self.build_log = ""
        self._lib = None

    @property
    def source(self) -> str:
        return os.path.join(CSRC, self.name + ".cu")

    @property
    def lib_path(self) -> str:
        return os.path.join(BUILD_DIR, f"lib{self.name}.so")

    def stale(self) -> bool:
        if not os.path.exists(self.lib_path):
            return True
        built = os.path.getmtime(self.lib_path)
        return any(os.path.getmtime(s) > built
                   for s in (self.source, _COMMON))

    def start_build(self) -> subprocess.Popen:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = self.lib_path + f".{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, self.source]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp_path = tmp
        return proc

    def finish_build(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(proc.tmp_path, self.lib_path)

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            if self.stale():
                self.finish_build(self.start_build())
            lib = ctypes.CDLL(self.lib_path)
            for fn, argtypes in self.entry_points.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes) + [P]
                f.restype = I
            self._lib = lib
        return self._lib

    def reset(self) -> None:
        self.launches = 0
        self.variants.clear()

    def launch(self, fn: str, *args, variant: str = "") -> None:
        """Call entry point ``fn`` on the current CUDA stream; raise on a
        launch error. ``variant`` labels the launch in ``variants``."""
        import torch
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(self.lib(), fn)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}")
        self.launches += 1
        self.variants[variant or fn] += 1


def build_all(kernels) -> None:
    """Compile every stale library at once (one nvcc process each)."""
    procs = [(k, k.start_build()) for k in kernels if k.stale()]
    for k, p in procs:
        k.finish_build(p)
    for k in kernels:
        k.lib()
