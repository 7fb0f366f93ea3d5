"""Block-sharded forest encoding (port of
nr3d_lib_tpu/parallel/forest_parallel.py).

The forest's per-block parameter rows are split over the mesh's
``block`` axis: each rank holds its blocks' rows. Every sample belongs
to one block, so the rank that owns it computes its features and every
other rank gives exact zeros (the classic LoTD encode gives zeros for
`bidx = -1`); one all-reduce over the ``block`` group sums the ranks'
features. The block gradients stay on their owner: a rank's encode
scatters dL/dparams only into its own rows.

The all-reduce's backward passes the cotangent through unchanged: every
rank of the group computes the same loss from the summed features, so
each rank's cotangent already is the full cotangent of its own part, as
the transpose of JAX's `psum` under `shard_map` gives. (An all-reduce in
the backward too, as `torch.distributed.nn.functional.all_reduce` does,
would scale the block gradients by the group's size.)

Compose with a ``data`` axis for data × block parallelism: each rank
takes its own rays; the gradients' mean runs over ``data``, the
features' sum over ``block``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from nr3d_lib_tpu_torch.ops.lotd import LoDMeta, lotd_encode
from nr3d_lib_tpu_torch.parallel.train import mean_loss, mean_over_group

__all__ = ["pad_blocks_for_sharding", "forest_encode_block_sharded",
           "make_forest_sharded_train_step"]


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over a group forward; the cotangent unchanged
    backward (see the module's docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return x
    return _SumOverGroup.apply(x, group)


def local_rows(table: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's rows of a table split by rows over `axis`: a `DTensor`'s
    local shard, or its slice of a full (padded) table."""
    from torch.distributed.tensor import DTensor

    if isinstance(table, DTensor):
        return table.to_local()
    n, c = mesh[axis].size(), mesh.get_local_rank(axis)
    if table.shape[0] % n:
        raise ValueError(f"{table.shape[0]} rows do not split over {n} "
                         f"ranks; pad them first")
    k = table.shape[0] // n
    return table[c * k:(c + 1) * k]


def pad_blocks_for_sharding(params: torch.Tensor,
                            n_shards: int) -> torch.Tensor:
    """Pad the block axis up to a multiple of n_shards (padding blocks are
    never addressed: bidx stays < n_blocks)."""
    nb = params.shape[0]
    target = -(-nb // n_shards) * n_shards
    if target != nb:
        params = F.pad(params, (0, 0, 0, target - nb))
    return params


def forest_encode_block_sharded(x: torch.Tensor, bidx: torch.Tensor,
                                params: torch.Tensor, meta: LoDMeta, mesh,
                                block_axis: str = "block") -> torch.Tensor:
    """Forest encode with the per-block parameters split over
    `block_axis`.

    x [N, D] block-local coordinates in [0,1] and bidx [N] global block
    indices (−1 → zero features) are this rank's samples; params is the
    padded [n_blocks, n_params] table (this rank uses its rows) or a
    `DTensor` sharded `Shard(0)` over `block_axis`. Returns [N, n_feats].
    """
    local = local_rows(params, mesh, block_axis)
    nb_local = local.shape[0]
    lo = mesh.get_local_rank(block_axis) * nb_local
    owned = (bidx >= lo) & (bidx < lo + nb_local)
    enc = lotd_encode(x, local, meta,
                      bidx=torch.where(owned, bidx - lo, -1))
    return sum_over_group(enc, mesh.get_group(block_axis))


def make_forest_sharded_train_step(loss_fn, optimizer, meta: LoDMeta, mesh,
                                   block_axis: str = "block",
                                   data_axis: str = "data"):
    """A data × block parallel train step for a forest encoding.

    loss_fn(other, feats, batch) → scalar over this rank's rays. Returns
    step(params, batch) → the mean of the data ranks' losses, where
    params = {"blocks": the block table (see
    `forest_encode_block_sharded`), "other": the rest} are the tensors
    `optimizer` steps, and batch = {"x", "bidx", ...} this rank's rays.
    The gradients' mean over `data_axis` precedes the optimizer's step;
    each rank's block gradients are non-zero only in its own rows.
    """
    group = mesh.get_group(data_axis)
    owned = [p for g in optimizer.param_groups for p in g["params"]]

    def step(params, batch):
        optimizer.zero_grad(set_to_none=True)
        feats = forest_encode_block_sharded(batch["x"], batch["bidx"],
                                            params["blocks"], meta, mesh,
                                            block_axis)
        loss = loss_fn(params["other"], feats, batch)
        loss.backward()
        mean_over_group(owned, group)
        optimizer.step()
        return mean_loss(loss, group)

    return step
