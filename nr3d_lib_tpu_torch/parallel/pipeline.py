"""Pipeline parallelism over a ``stage`` mesh axis (port of
nr3d_lib_tpu/parallel/pipeline.py).

`pipeline_apply` runs JAX's schedule for S stages and M microbatches:
at tick t ∈ [0, S+M−1) stage s processes microbatch t−s; every rank runs
every tick, and what a stage computes off the diagonal is never
recorded (bubble fraction (S−1)/(S+M−1)). After each tick the
activations rotate one stage forward through `dist.batch_isend_irecv`
over the ``stage`` group; the last stage's outputs are summed over the
group, so every rank returns them.

The rotation is differentiable: its backward rotates the activations'
gradients one stage back. Every rank takes part in every rotation of
the backward, in the order of the ticks: each tick's received
activations also feed the output through a `where` that selects none of
them, so no rotation drops out of the backward graph on any rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from nr3d_lib_tpu_torch.parallel.forest_parallel import sum_over_group

__all__ = ["pipeline_apply"]


def _exchange(send: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send.contiguous(), dst, group),
        dist.P2POp(dist.irecv, recv, src, group)])
    for r in reqs:
        r.wait()
    return recv


class _Rotate(torch.autograd.Function):
    """Send to the next stage, receive from the previous (global ranks);
    backward the other way round."""

    @staticmethod
    def forward(ctx, h, group, nxt: int, prev: int):
        ctx.group, ctx.nxt, ctx.prev = group, nxt, prev
        return _exchange(h, nxt, prev, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.prev, ctx.nxt, ctx.group), None, None, None


def pipeline_apply(stage_fn: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
                   stage_params: torch.Tensor, x_microbatches: torch.Tensor,
                   mesh, stage_axis: str = "stage") -> torch.Tensor:
    """Run `stage_fn(params_s, h)` for stages s = 0..S−1 over microbatches.

    stage_params: [S, ...] (this rank uses row s, its stage) or a
    `DTensor` sharded `Shard(0)` over `stage_axis`. x_microbatches:
    [M, B, F], the same on every rank. Returns [M, B, F] (stage_fn keeps
    the activation's shape) on every rank.
    """
    from torch.distributed.tensor import DTensor

    n_stages = mesh[stage_axis].size()
    sidx = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    p = stage_params.to_local()[0] if isinstance(stage_params, DTensor) \
        else stage_params[sidx]
    xs = x_microbatches
    n_micro = xs.shape[0]
    nxt = dist.get_global_rank(group, (sidx + 1) % n_stages)
    prev = dist.get_global_rank(group, (sidx - 1) % n_stages)
    never = torch.zeros((), dtype=torch.bool, device=xs.device)

    h = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(n_micro)]
    sink = torch.zeros((), dtype=xs.dtype, device=xs.device)
    for t in range(n_stages + n_micro - 1):
        if sidx == 0:
            h = xs[t] if t < n_micro else torch.zeros_like(xs[0])
        h2 = stage_fn(p, h)
        m_out = t - (n_stages - 1)
        if sidx == n_stages - 1 and 0 <= m_out < n_micro:
            outs[m_out] = h2
        if n_stages > 1:
            h = _Rotate.apply(h2, group, nxt, prev)
            sink = sink + torch.where(never, h, 0.0).sum()
        else:
            h = h2
    return sum_over_group(torch.stack(outs) + sink, group)
