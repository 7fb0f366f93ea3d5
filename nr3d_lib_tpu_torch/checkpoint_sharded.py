"""Sharded checkpoints of nested dicts of tensors through
`torch.distributed.checkpoint` (port of nr3d_lib_tpu/checkpoint_sharded.py,
which uses orbax).

Each rank writes its own shards of `DTensor`s (and rank 0 the plain
tensors and other values), and a load places each value straight onto
the template's placement, which may differ from the one saved: a
`Shard(0)` table saved by two ranks loads as `Replicate()`, or onto one
rank. Without a process group it is one process writing and reading
everything.

Usage::

    save_sharded("ckpts/step_1000", {"blocks": blocks, "opt": opt_state})
    tmpl = {"blocks": abstract_like(blocks2), "opt": abstract_like(opt2)}
    state = load_sharded("ckpts/step_1000", tmpl)
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import torch
import torch.distributed as dist

from nr3d_lib_tpu_torch.utils import tree_map

__all__ = ["save_sharded", "load_sharded", "abstract_like"]


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def abstract_like(x) -> Any:
    """The load template of `x`: an uninitialised tensor of its shape,
    dtype, device and (for a `DTensor`) placement, or a nested dict of
    them; other values stand as they are."""
    return tree_map(lambda v: torch.empty_like(v)
                     if isinstance(v, torch.Tensor) else v, x)


def save_sharded(path: str, tree: Any) -> str:
    """Write a nested dict of tensors and `DTensor`s (and plain values);
    returns when the write is complete on every rank. A checkpoint at
    `path` is replaced."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    group = _in_group()
    if not group or dist.get_rank() == 0:
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
    if group:
        dist.barrier()
    dcp.save(tree, checkpoint_id=path, no_dist=not group)
    return path


def load_sharded(path: str, template: Any) -> Any:
    """Read a checkpoint of `save_sharded` into new tensors shaped and
    placed as `template`'s leaves (tensors, `DTensor`s or `abstract_like`
    outputs; the template itself is not written). Each leaf's placement
    may differ from the one it was saved with."""
    import torch.distributed.checkpoint as dcp

    state = abstract_like(template)
    dcp.load(state, checkpoint_id=os.path.abspath(path),
             no_dist=not _in_group())
    return state
