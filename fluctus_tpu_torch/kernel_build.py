"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C launcher (pointers, ints and the
stream) and is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library under ``_build/`` (git-ignored), keyed by a hash of the sources
and flags, then loaded with ``ctypes``. Building with nvcc alone takes
seconds per file; a PyTorch C++ extension would include torch's headers
and take minutes. ``build_all`` starts one nvcc per source at once.

``-fmad=false`` keeps ``a*b+c`` as two rounded operations: a fused
multiply-add would move the last bit of the slab ``tnear`` and of the
affine ``t``, and with them the packed winner key, the candidate order and
which of two near-tied triangles wins. Divisions stay IEEE
(``-prec-div=true``).

Every launcher returns its ``cudaError_t``; ``Kernel.__call__`` raises on
a non-zero code and counts the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    cand = [os.path.join(os.environ[k], "bin", "nvcc")
            for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    cand += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name == source or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _start_build(source: str):
    """Start nvcc for one source unless its library exists. Returns
    (process or None, temp path, final path, log path)."""
    out = _lib_path(source)
    if os.path.exists(out):
        return None, None, out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = os.path.splitext(out)[0] + ".log"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    with open(log, "w") as lf:
        proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish_build(proc, tmp, out, log):
    if proc is None:
        return
    rc = proc.wait()
    if rc != 0:
        with open(log) as f:
            raise RuntimeError(f"nvcc failed ({rc}) for {out}:\n{f.read()}")
    os.replace(tmp, out)


def build_all() -> dict:
    """Compile every csrc/*.cu in parallel (one nvcc each). Returns
    {source: seconds to its library} — 0 for a cached build."""
    t0 = time.time()
    sources = sorted(s for s in os.listdir(CSRC) if s.endswith(".cu"))
    jobs = [(s, _start_build(s)) for s in sources]
    secs = {}
    for s, job in jobs:
        _finish_build(*job)
        secs[s] = round(time.time() - t0, 3) if job[0] is not None else 0.0
    return secs


def build_log(source: str) -> str:
    """The nvcc/ptxas output (registers, shared memory, spills) of the
    library built for ``source``, or '' when it was built elsewhere."""
    log = os.path.splitext(_lib_path(source))[0] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


class Kernel:
    """One CUDA launcher: ``symbol`` in the library built from ``source``.
    ``launches`` counts successful launches, and ``launches_by`` the same
    launches by the ``variant`` the wrapper names (K4: its channel count);
    ``plain_runs`` counts calls of the plain PyTorch version beside it
    (bumped by that function)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self.launches_by = {}
        self.plain_runs = 0
        self._fn = None
        self._err = None
        KERNELS[name] = self

    def _load(self):
        if self._fn is None:
            _finish_build(*_start_build(self.source))
            lib = ctypes.CDLL(_lib_path(self.source))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def __call__(self, *args, variant=None):
        fn = self._load()
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc} "
                               f"({self._err(rc).decode()})")
        self.launches += 1
        if variant is not None:
            self.launches_by[variant] = self.launches_by.get(variant, 0) + 1


KERNELS: dict = {}


def reset_counts():
    for k in KERNELS.values():
        k.launches = 0
        k.launches_by = {}
        k.plain_runs = 0


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check_cuda(name: str, *tensors, dtypes=None):
    """Validate the tensors handed to a kernel: CUDA, contiguous, and of
    the expected dtypes (a tuple, one per tensor)."""
    for k, t in enumerate(tensors):
        if not t.is_cuda:
            raise ValueError(f"{name}: argument {k} is not a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {k} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[k]:
            raise ValueError(f"{name}: argument {k} has dtype {t.dtype}, "
                             f"expected {dtypes[k]}")
