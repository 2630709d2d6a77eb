"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Route: ``nvcc`` compiles each ``csrc/<name>.cu`` (a plain C interface, no
PyTorch headers) into ``build/aom_av1_psy_tpu_torch/lib<name>.so`` at first
use, and ``ctypes`` loads it. A library is rebuilt when its source or a
shared header (``csrc/*.cuh``) is newer (the same rule as the native range
coder's build).
Pointers come from ``tensor.data_ptr()`` and the stream is the current
device's current stream (its raw handle, without building a
``torch.cuda.Stream``). Every C entry point launches on that stream, does
not synchronise, and returns ``cudaGetLastError()``; ``CudaKernel.launch``
raises on a non-zero code. The ctypes functions are resolved once, when
the library loads.

Every call names the CUDA device its tensors lie on (``device=``, the
index) and raises ``WrongDevice`` when that is not the current device: a
kernel never runs on another card's stream. Code that works on several
cards enters each one (``device.on_device``) before it calls a wrapper.

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

from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "aom_av1_psy_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
D = ctypes.c_double


_ALL = []          # every CudaKernel made


def launches_total() -> int:
    """The launches made so far through every ``CudaKernel``: the sum of
    their ``launches``."""
    return sum(k.launches for k in _ALL)


def nvcc_path() -> str:
    p = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(p):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ on a machine with the CUDA toolkit")
    return p


class CudaKernel:
    """One kernel of the ``csrc/<source>.cu`` library (``source`` defaults
    to ``name``; two kernels of one file are two objects with their own
    names and counts).

    ``entry_points`` maps each C function to its ctypes argument types (the
    stream is the last argument of every one). ``launches`` counts the
    kernel launches made through :meth:`launch`; ``variants`` counts them
    again by the label the wrapper passes (block size, mode), so a caller
    can tell which instance of a kernel ran."""

    def __init__(self, name: str, entry_points: dict, source: str = ""):
        self.name = name
        self.source_name = source or name
        self.entry_points = entry_points
        self.launches = 0
        self.variants = collections.Counter()
        self.build_log = ""
        self._lib = None
        self._fns = {}
        self._raw = self._current = None
        _ALL.append(self)

    @property
    def source(self) -> str:
        return os.path.join(CSRC, self.source_name + ".cu")

    @property
    def lib_path(self) -> str:
        return os.path.join(BUILD_DIR, f"lib{self.source_name}.so")

    def stale(self) -> bool:
        if not os.path.exists(self.lib_path):
            return True
        built = os.path.getmtime(self.lib_path)
        headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                   if f.endswith(".cuh")]
        return any(os.path.getmtime(s) > built
                   for s in (self.source, *headers))

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
            import torch
            if self.stale():
                self.finish_build(self.start_build())
            lib = ctypes.CDLL(self.lib_path)
            for fn, argtypes in self.entry_points.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes) + [P]
                f.restype = I
                self._fns[fn] = f
            # the current device's current stream, as a raw handle (the
            # device from torch's own getter: a launch finds CUDA set up)
            self._raw = torch._C._cuda_getCurrentRawStream
            self._current = torch._C._cuda_getDevice
            self._lib = lib
        return self._lib

    def reset(self) -> None:
        self.launches = 0
        self.variants.clear()

    def stream_on(self, device: int):
        """The current stream's raw handle, after the guard: raises
        ``WrongDevice`` unless ``device`` (the index of the card the
        call's tensors lie on) is the current device."""
        cur = self._current()
        if device != cur:
            raise WrongDevice(f"{self.name}: tensors on cuda:{device}, but "
                              f"the current device is cuda:{cur}; enter "
                              f"torch.cuda.device({device}) first")
        return self._raw(cur)

    def call(self, fn: str, *args, device: int) -> None:
        """Call entry point ``fn`` on device ``device``'s current stream
        (which must be the current device); raise on a CUDA error. Not
        counted: for set-up entries that launch no kernel."""
        if self._lib is None:
            self.lib()
        rc = self._fns[fn](*args, self.stream_on(device))
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}")

    def launch(self, fn: str, *args, device: int, variant: str = "") -> None:
        """Call entry point ``fn``, which launches the kernel on the
        current stream of device ``device``, the card its tensors lie on
        (it must be the current device); raise on a launch error.
        ``variant`` labels the launch in ``variants``. Under a profiler
        the C entry's call is a ``launch`` span (``utils.trace``)."""
        if self._lib is None:
            self.lib()
        stream = self.stream_on(device)
        if trace.profiling():
            with trace.span("launch", kernel=self.name,
                            variant=variant or fn):
                rc = self._fns[fn](*args, stream)
        else:
            rc = self._fns[fn](*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}")
        self.launches += 1
        self.variants[variant or fn] += 1


class WrongDevice(RuntimeError):
    """A kernel call whose tensors lie on another card than the current
    device."""


def need(t, dtype, shape, di: int, what: str) -> int:
    """``t``'s data pointer after a wrapper's checks (0 for None): a
    contiguous ``dtype`` tensor of ``shape`` on CUDA device ``di``; raises
    ``ValueError`` naming ``what`` otherwise."""
    if t is None:
        return 0
    if t.get_device() != di or t.dtype != dtype or tuple(t.shape) != \
            tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: want contiguous {dtype} {tuple(shape)} "
                         f"on cuda:{di}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.data_ptr()


def build_all(kernels) -> None:
    """Compile every stale library at once (one nvcc process each, one per
    source file however many kernels it holds)."""
    procs = {}
    for k in kernels:
        if k.lib_path not in procs and k.stale():
            procs[k.lib_path] = (k, k.start_build())
    for k, p in procs.values():
        k.finish_build(p)
    for k in kernels:
        k.lib()
