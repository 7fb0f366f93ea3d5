"""Forest occupancy: a grid per block over a `ForestBlockSpace` (port of
nr3d_lib_tpu/models/accelerations/occgrid_forest.py `OccGridAccelForest`).

World rays are marched at fixed candidate steps, or at steps inside the
space's block segments, and each candidate is masked by (block occupied) ∧
(the block's grid cell occupied): empty blocks and empty cells cost a mask
bit; the compaction downstream drops them before any network query.

State: the batched EMA grids `occ.val_grid` [n_trees, r, r, r]. The space
is the model's (held here without registering it again).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.graphics.raysample import Draw
from nr3d_lib_tpu_torch.models.accelerations.occgrid_batched import \
    OccGridEmaBatched
from nr3d_lib_tpu_torch.ops.occgrid_march import march_steps

__all__ = ["OccGridAccelForest"]


class OccGridAccelForest(nn.Module):
    """Per-block occupancy grids, their slots shared with the space. An
    update queries a world-space `val_query_fn(x_world [n,3]) → [n]` at
    block-local cells mapped back to the world."""

    def __init__(self, space, *, resolution=(16, 16, 16),
                 occ_thre: float = 0.01, ema_decay: float = 0.95,
                 update_every: int = 16, step_size: Optional[float] = None,
                 max_steps_per_ray: int = 256, device=None, **_):
        super().__init__()
        object.__setattr__(self, "space", space)   # the model registers it
        n_trees = max(int(space.n_trees), 1)
        self.occ = OccGridEmaBatched(n_trees, resolution, occ_thre,
                                     ema_decay, device=device)
        self.update_every = int(update_every)
        self.max_steps_per_ray = int(max_steps_per_ray)
        self.step_size = float(step_size if step_size is not None
                               else space.block_size / 16.0)

    # ------------------------------------------------------------- updates
    def _local_to_world(self, x_local: torch.Tensor, bidx: torch.Tensor
                        ) -> torch.Tensor:
        """Block-local [-1,1] → world, per block slot."""
        corners = self.space.block_coords[torch.clamp(bidx, min=0).long()]
        lo = self.space.origin + corners.to(x_local.dtype) * \
            self.space.block_size
        return lo + (x_local + 1.0) * 0.5 * self.space.block_size

    def _wrap_query(self, val_query_fn: Callable) -> Callable:
        def fn(x_local, bidx):
            b, n, _ = x_local.shape
            xw = self._local_to_world(x_local.reshape(b * n, 3),
                                      bidx.reshape(b * n))
            return val_query_fn(xw).reshape(b, n)
        return fn

    def init(self, generator: torch.Generator,
             val_query_fn: Optional[Callable] = None) -> None:
        if val_query_fn is not None:
            self.occ.step_update(generator, self._wrap_query(val_query_fn))

    def step(self, it: int, generator: torch.Generator,
             val_query_fn: Callable) -> None:
        """Every `update_every` iterations (it = 0 included), the EMA
        re-query of every block's grid."""
        if it % self.update_every == 0:
            self.occ.step_update(generator, self._wrap_query(val_query_fn))

    # ------------------------------------------------------------- queries
    def query(self, x_world: torch.Tensor) -> torch.Tensor:
        """Occupancy bit of each world point: block occupied ∧ cell
        occupied (a plain gather, as in JAX)."""
        bidx = self.space.block_of_points(x_world)
        x_local = self.space.normalize_coords(x_world, bidx)
        res = torch.as_tensor(self.occ.resolution, device=x_world.device)
        cell = torch.floor((x_local + 1.0) * 0.5 * res).to(torch.int64)
        inb = torch.all((cell >= 0) & (cell < res), -1)
        cell = torch.minimum(torch.clamp(cell, min=0), res - 1)
        occ = self.occ.occ()[torch.clamp(bidx, min=0).long(), cell[..., 0],
                             cell[..., 1], cell[..., 2]]
        return occ & inb & (bidx >= 0)

    def ray_march(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                  near: torch.Tensor, far: torch.Tensor, *,
                  n_steps: Optional[int] = None,
                  u: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
        """World rays at fixed steps → (t, dt, bidx, mask) [R, S], mask =
        in range ∧ occupied; `u` [R, S] jitters the steps."""
        t, dt, in_range = march_steps(near, far,
                                      n_steps or self.max_steps_per_ray,
                                      self.step_size, u=u)
        x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        bidx = self.space.block_of_points(x)
        return t, dt, bidx, in_range & self.query(x)

    def ray_march_segmented(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                            near: torch.Tensor, far: torch.Tensor, *,
                            max_segments: int = 32,
                            steps_per_segment: int = 16,
                            draw: Optional[Draw] = None
                            ) -> Tuple[torch.Tensor, ...]:
        """Steps only inside the rays' block segments (no slot is spent on
        the empty space between blocks), then the cell-occupancy mask →
        (t, dt, bidx, mask) [R, K·S]; `draw` jitters the steps (one [R, K,
        S] draw in [0,1), the JAX version's `perturb_key` draw)."""
        segs = self.space.ray_test_segments(rays_o, rays_d, near, far,
                                            max_segments=max_segments)
        u = None if draw is None else draw(
            tuple(segs["seg_t_in"].shape) + (steps_per_segment,), 0.0, 1.0)
        t, dt, bidx, mask = self.space.march_segments(
            segs, steps_per_segment=steps_per_segment, u=u)
        x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        return t, dt, bidx, mask & self.query(x)
