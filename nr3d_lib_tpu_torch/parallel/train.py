"""Data-parallel training step (port of nr3d_lib_tpu/parallel/train.py).

JAX shards the rays over the mesh's ``data`` axis and lets `jit` insert
the gradient all-reduce. Here each rank takes its own slice of the rays
(`shard_rays`), computes the loss and its gradients on them, and the
step all-reduces the mean gradient over the ``data`` group before the
optimizer steps, so every rank keeps the same parameters.

The step averages the ranks' losses. For a mean over rays with equal
shards that is the full batch's loss; a term that averages over a
rank's own samples (the eikonal term over the valid nablas) gives the
mean of the ranks' terms, not the term over the union.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from nr3d_lib_tpu_torch.parallel import get_mesh
from nr3d_lib_tpu_torch.utils import tree_map

__all__ = ["make_sharded_train_step", "shard_rays", "replicate"]


def shard_rays(tree, mesh=None):
    """This rank's slice of dim 0 of every tensor of `tree` along the
    mesh's ``data`` axis (dim 0 must divide by the axis size)."""
    mesh = mesh or get_mesh()
    n, c = mesh["data"].size(), mesh.get_local_rank("data")

    def cut(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} "
                             "data ranks")
        k = x.shape[0] // n
        return x[c * k:(c + 1) * k]

    return tree_map(cut, tree)


def replicate(tree, mesh=None):
    """Copies of `tree`'s tensors holding the values of the mesh's first
    rank on every rank (a broadcast along each axis in turn)."""
    mesh = mesh or get_mesh()

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().clone()
        for axis in mesh.mesh_dim_names:
            group = mesh.get_group(axis)
            if dist.get_world_size(group) == 1:
                continue
            dist.broadcast(x, src=dist.get_global_rank(group, 0),
                           group=group)
        return x

    return tree_map(bcast, tree)


def mean_over_group(params, group) -> None:
    """Replace each parameter's gradient by its mean over `group`'s ranks,
    in one all-reduce a dtype (none in a group of one). A parameter
    without a gradient on every rank keeps none."""
    n = dist.get_world_size(group)
    if n == 1:
        return
    params = list(params)
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.int32, device=params[0].device)
    dist.all_reduce(has, op=dist.ReduceOp.MAX, group=group)
    live = [p for p, h in zip(params, has.tolist()) if h]
    for dtype in dict.fromkeys(p.dtype for p in live):
        ps = [p for p in live if p.dtype == dtype]
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1) for p in ps])
        dist.all_reduce(flat, group=group)
        flat /= n
        offset = 0
        for p in ps:
            p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
            offset += p.numel()


def mean_loss(loss: torch.Tensor, group) -> torch.Tensor:
    """The mean of the ranks' (detached) losses over `group`."""
    if dist.get_world_size(group) == 1:
        return loss.detach()
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=group)
    return loss / dist.get_world_size(group)


def make_sharded_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                            mesh=None):
    """A data-parallel train step over the mesh's ``data`` group.

    loss_fn(batch, generator) → scalar loss on this rank's rays (`batch`
    from `shard_rays`; `generator` this rank's draws). Returns
    step(batch, generator=None) → the mean of the ranks' losses
    (detached): backward, the gradients' mean over the ``data`` group,
    then `optimizer.step()` on the optimizer's parameters.
    """
    mesh = mesh or get_mesh()
    group = mesh.get_group("data")
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch, generator: Optional[torch.Generator] = None):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch, generator)
        loss.backward()
        mean_over_group(params, group)
        optimizer.step()
        return mean_loss(loss, group)

    return step
