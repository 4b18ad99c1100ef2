"""The native (C++) SAH BVH builder, bound with ctypes.

``bvh_builder.cpp`` is compiled with ``g++ -O3`` at first use into the
package's git-ignored ``_build/`` directory, under a name keyed by a hash
of the source. A failed compile raises with the compiler's message; there
is no silent fall-back to the numpy builder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..accel.bvh import BVHArrays

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(" ".join(_FLAGS).encode() + f.read())
    return os.path.join(_BUILD_DIR, f"libflbvh-{h.hexdigest()[:16]}.so")


def get_lib():
    """Load the native library, compiling it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = _lib_path()
        if not os.path.exists(out):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            res = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                                 capture_output=True, text=True, timeout=240)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed ({res.returncode}) for "
                                   f"{_SRC}:\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        lib.flbvh_build.restype = ctypes.c_int64
        lib.flbvh_build.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.flbvh_num_indices.restype = ctypes.c_int64
        lib.flbvh_read.argtypes = [ctypes.c_void_p] * 6
        lib.flbvh_read.restype = None
        _lib = lib
        return _lib


def build_bvh_native(positions: np.ndarray) -> BVHArrays:
    """positions [M, 3, 3] -> BVHArrays, equal to ``accel.build_bvh``'s
    full-sweep SAH result."""
    lib = get_lib()
    tris = np.ascontiguousarray(positions.reshape(-1, 9), np.float32)
    with _lock:     # the library keeps one builder at a time
        n_nodes = lib.flbvh_build(tris.ctypes.data, tris.shape[0])
        n_idx = lib.flbvh_num_indices()
        box_min = np.empty((n_nodes, 3), np.float32)
        box_max = np.empty((n_nodes, 3), np.float32)
        right = np.empty(n_nodes, np.uint32)
        parent = np.empty(n_nodes, np.int32)
        nprims = np.empty(n_nodes, np.uint8)
        indices = np.empty(n_idx, np.uint32)
        lib.flbvh_read(box_min.ctypes.data, box_max.ctypes.data,
                       right.ctypes.data, parent.ctypes.data,
                       nprims.ctypes.data, indices.ctypes.data)
    return BVHArrays(box_min, box_max, right, parent, nprims, indices)
