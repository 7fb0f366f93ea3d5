"""Host-side native code: the marching tetrahedra (the port's counterpart of
nr3d_lib_tpu/bindings.py `load_mcubes`, `marching_tets_native`).

`csrc/host/mcubes.cpp` (the port's own copy of the JAX package's
`csrc/mcubes/mcubes.cpp`) is compiled at first use with g++ into
`_build/`, named by a hash of the source, and loaded with ctypes. A
failed build or load raises: there is no slower path to fall back on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["load_mcubes", "marching_tets_native"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "mcubes.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lib = None
_lock = threading.Lock()


def load_mcubes() -> ctypes.CDLL:
    """Build (once) and load the library; raises RuntimeError when g++
    fails or the library does not load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                           ).hexdigest()[:12]
        so = BUILD_DIR / f"libmcubes_{tag}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o",
                                str(tmp)], capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                                   f"{r.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.mt_extract.restype = ctypes.c_int
        lib.mt_extract.argtypes = [ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float]
        lib.mt_counts.argtypes = [ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.mt_copy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int32)]
        lib.mt_free.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def marching_tets_native(volume: np.ndarray, level: float = 0.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of a dense [nx, ny, nz] grid in grid units → (verts
    [V,3] float32, faces [F,3] int32)."""
    lib = load_mcubes()
    vol = np.ascontiguousarray(volume, np.float32)
    nx, ny, nz = vol.shape
    h = lib.mt_extract(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       nx, ny, nz, float(level))
    if h < 0:
        raise RuntimeError(f"mt_extract refused a {vol.shape} volume")
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    lib.mt_counts(h, ctypes.byref(nv), ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    if nv.value:
        lib.mt_copy(h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    lib.mt_free(h)
    return verts, faces
