"""Multi-process parallelism: process groups and one device mesh (port of
nr3d_lib_tpu/parallel/__init__.py).

Where JAX has one `Mesh` and lets `jit`/`shard_map` emit the
collectives, the port has `torch.distributed` process groups and a
`DeviceMesh` with the same axis names:

  * ``data``  — rays / pixels / batch elements (data parallel; gradients
    all-reduced over it);
  * ``block`` — scene blocks (the forest's blocks sharded over it).

`init_env()` initialises `torch.distributed` from the variables
`torchrun` sets (or explicit arguments) and does nothing for a single
process; `make_mesh()` builds the mesh the `parallel.*` modules use. A
user launches N processes on N cards with
``torchrun --nproc_per_node N script.py``.
"""

from __future__ import annotations

import datetime
import os
import random
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_env", "set_seed", "rank", "local_rank", "world_size",
           "is_master", "make_mesh", "get_mesh", "data_parallel_spec",
           "replicated_spec"]

_STATE = {"seed": 42, "mesh": None}
# how long a collective of `init_env`'s group waits for the other ranks
_TIMEOUT = datetime.timedelta(minutes=10)


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _in_group() else 0


def local_rank() -> int:
    """This process's index on its host (`LOCAL_RANK`, as torchrun sets
    it), else its global rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def world_size() -> int:
    return dist.get_world_size() if _in_group() else 1


def is_master() -> bool:
    """Rank 0 of the group; true without one."""
    return rank() == 0


def init_env(seed: int = 42, coordinator_address: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None) -> None:
    """Initialise `torch.distributed` and seed the host's RNGs.

    A group is made when `coordinator_address` (an `init_method` URL such
    as ``tcp://host:port`` or ``file:///path``) is given or torchrun's
    variables (`WORLD_SIZE` > 1) are set; a single process makes none.
    `num_processes` and `process_id` default to `WORLD_SIZE` and `RANK`.
    The backend is NCCL where there is a card, each process taking the
    card `LOCAL_RANK`, else gloo.
    """
    if not _in_group():
        n = num_processes if num_processes is not None else \
            int(os.environ.get("WORLD_SIZE", "1"))
        if coordinator_address is not None or n > 1:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
            if backend == "nccl":
                torch.cuda.set_device(local_rank() % torch.cuda.device_count())
            dist.init_process_group(
                backend, init_method=coordinator_address or "env://",
                world_size=n, rank=process_id if process_id is not None
                else int(os.environ.get("RANK", "0")), timeout=_TIMEOUT)
    set_seed(seed)


def set_seed(seed: int) -> None:
    """Record the base seed and seed numpy, Python and torch's global
    generators with it (the port's draws take explicit generators; these
    seed host-side sampling)."""
    _STATE["seed"] = seed
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def _device_type() -> str:
    """The mesh's device type: where the default group's backend moves
    tensors (NCCL: the card; gloo, which also takes CUDA tensors: the
    card when there is one)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data", "block"),
              device_type: Optional[str] = None):
    """The global `DeviceMesh` over every rank, axes `axis_names` (with no
    sizes: all ranks along ``data``, 1 along the others). A single process
    without a group gets a group of one (gloo, in memory) first, which
    carries no collective: the `parallel.*` steps skip them at size 1. A
    process that torchrun started as one of several (`WORLD_SIZE` > 1)
    must call `init_env()` first."""
    from torch.distributed.device_mesh import init_device_mesh

    if not _in_group():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError("WORLD_SIZE > 1 and no process group: call "
                               "parallel.init_env() before make_mesh()")
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"mesh axes {list(axis_sizes)} != {n} ranks")
    # every axis's groups on the default group's backend: gloo ranks that
    # share a card would otherwise get NCCL subgroups, which refuse that
    backend = dist.get_backend()
    mesh = init_device_mesh(device_type or _device_type(), tuple(axis_sizes),
                            mesh_dim_names=tuple(axis_names),
                            backend_override={a: backend
                                              for a in axis_names})
    _STATE["mesh"] = mesh
    return mesh


def get_mesh():
    if _STATE["mesh"] is None:
        return make_mesh()
    return _STATE["mesh"]


def data_parallel_spec():
    """The placement of per-ray tensors on the ``data`` axis."""
    from torch.distributed.tensor import Shard

    return Shard(0)


def replicated_spec():
    from torch.distributed.tensor import Replicate

    return Replicate()
