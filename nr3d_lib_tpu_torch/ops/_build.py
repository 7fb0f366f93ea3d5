"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded through `ctypes` (no PyTorch
headers, so a build takes seconds). Libraries land in `_build/` under the
package at first use, named by a hash of their source and of the shared
headers (`csrc/*.cuh`), so an edited source or header is rebuilt and an
unchanged one is reused.

Every C entry returns `cudaGetLastError()` after its launch; `check` turns
a non-zero code into an exception. Nothing here falls back to a plain
version: a kernel that cannot build or launch raises.

`LAUNCHES` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["LAUNCHES", "KERNEL_SOURCES", "build_all", "load", "check",
           "stream_ptr", "NVCC_FLAGS", "VP"]

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = ("brick4", "brick", "gather1d", "permuto_cell4",
                  "permuto_cell", "gaussian_blend", "occ_march")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: "collections.Counter[str]" = collections.Counter()
# ptxas report (registers, shared memory, spills) of each library built by
# this process, by source name
PTXAS_REPORT: Dict[str, str] = {}

VP = ctypes.c_void_p     # every pointer and stream argument
_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every shared
    header (`csrc/*.cuh`) and the flags."""
    h = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    text, _ = proc.communicate()
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc {proc.returncode}):\n{text}")
    os.replace(tmp, out)          # atomic: concurrent builds never clash
    PTXAS_REPORT[name] = text


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> None:
    """Compile every missing library, one `nvcc` per source, all started
    together."""
    names = list(names)
    with _lock:
        procs = [(n, _start(n)) for n in names]
        for n, p in procs:
            _finish(n, p)


def load(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed, with
    each C entry's `argtypes` declared (every entry returns an int CUDA
    error code)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, types in argtypes.items():
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
