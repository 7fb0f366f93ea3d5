"""Batched and time-keyed occupancy grids (port of nr3d_lib_tpu/models/
accelerations/occgrid_batched.py `OccGridEmaBatched`, `OccGridAccelBatched`
(`step`), `OccGridAccelDynamic`): B instances or T time keys each own a
grid, updated together. `ray_march` waits (ROADMAP.md A12): the dynamic
NeuS query samples without marching.

As in `occgrid.py`, the update is split so that a test can hand over the
JAX package's draws: `sample_update_cells` draws n uniform cells and a
point inside each per grid, `apply_update` decays and scatter-maxes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nr3d_lib_tpu_torch.models.accelerations.occgrid import \
    sample_cells_uniform

__all__ = ["OccGridEmaBatched", "OccGridAccelBatched", "OccGridAccelDynamic"]

QueryFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class OccGridEmaBatched(nn.Module):
    """[B, r, r, r] EMA value grids. State: the buffer ``val_grid``."""

    def __init__(self, n_batch: int, resolution=(32, 32, 32),
                 occ_thre: float = 0.01, ema_decay: float = 0.95,
                 device=None):
        super().__init__()
        if np.isscalar(resolution):
            resolution = (int(resolution),) * 3
        self.n_batch = int(n_batch)
        self.resolution = tuple(int(r) for r in resolution)
        self.occ_thre = float(occ_thre)
        self.ema_decay = float(ema_decay)
        self.register_buffer("val_grid", torch.ones(
            (self.n_batch,) + self.resolution, dtype=torch.float32,
            device=device))

    def occ(self) -> torch.Tensor:
        return self.val_grid > self.occ_thre

    def _flat(self, b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        r0, r1, r2 = self.resolution
        return ((b * r0 + idx[..., 0]) * r1 + idx[..., 1]) * r2 + idx[..., 2]

    def collect_samples(self, bidx: torch.Tensor, x: torch.Tensor,
                        vals: torch.Tensor) -> None:
        """Scatter-max |vals| of points x [..., 3] in [-1,1] into grid
        bidx; points outside the grid or with bidx < 0 are dropped."""
        res = torch.as_tensor(self.resolution, device=x.device)
        idx = torch.floor((x + 1.0) * 0.5 * res).to(torch.int64)
        inb = torch.all((idx >= 0) & (idx < res), -1) & (bidx >= 0)
        idx = torch.minimum(torch.clamp(idx, min=0), res - 1)
        flat = self._flat(torch.clamp(bidx, min=0).to(torch.int64), idx)
        vals = torch.where(inb, torch.abs(vals),
                           torch.full_like(vals, -float("inf")))
        grid = self.val_grid.reshape(-1)
        grid.scatter_reduce_(0, flat.reshape(-1), vals.reshape(-1),
                             reduce="amax")

    def sample_update_cells(self, generator: torch.Generator,
                            n_samples: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """n uniform cells and a uniform point inside each, per grid →
        (idx [B,n,3] int64, x [B,n,3]); n defaults to a quarter of a grid's
        cells."""
        n = n_samples or max(int(np.prod(self.resolution)) // 4, 1)
        draws = [sample_cells_uniform(generator, self.resolution, n)
                 for _ in range(self.n_batch)]
        dev = self.val_grid.device
        return (torch.stack([d[0] for d in draws]).to(dev),
                torch.stack([d[1] for d in draws]).to(dev))

    def apply_update(self, idx: torch.Tensor, x: torch.Tensor,
                     query_fn: QueryFn) -> None:
        """Decay every value by `ema_decay`, then scatter-max
        |query_fn(x [B,n,3], bidx [B,n])| into the cells idx. In place."""
        b = torch.arange(self.n_batch, device=x.device)[:, None].expand(
            idx.shape[:2])
        fresh = torch.abs(query_fn(x, b)).to(self.val_grid.dtype)
        grid = (self.val_grid * self.ema_decay).reshape(-1)
        grid.scatter_reduce_(0, self._flat(b, idx).reshape(-1),
                             fresh.reshape(-1), reduce="amax")
        self.val_grid.copy_(grid.reshape(self.val_grid.shape))

    def step_update(self, generator: torch.Generator, query_fn: QueryFn,
                    n_samples: Optional[int] = None) -> None:
        self.apply_update(*self.sample_update_cells(generator, n_samples),
                          query_fn)


class OccGridAccelBatched(nn.Module):
    """Per-instance occupancy accel: the batched EMA grids, updated every
    `update_every` steps. The march settings of the JAX config
    (`step_size`, `max_steps_per_ray`) are accepted and unused until
    `ray_march` is ported."""

    def __init__(self, n_batch: int, *, resolution=(32, 32, 32),
                 occ_thre: float = 0.01, ema_decay: float = 0.95,
                 update_every: int = 16, device=None, **_):
        super().__init__()
        self.occ = OccGridEmaBatched(n_batch, resolution, occ_thre,
                                     ema_decay, device=device)
        self.update_every = int(update_every)

    def step(self, it: int, generator: torch.Generator,
             query_fn: QueryFn) -> None:
        """Every `update_every` iterations (it = 0 included), the EMA
        re-query of every grid."""
        if it % self.update_every == 0:
            self.occ.step_update(generator, query_fn)

    def collect_samples(self, bidx, x, vals) -> None:
        self.occ.collect_samples(bidx, x, vals)


class OccGridAccelDynamic(OccGridAccelBatched):
    """Time-keyed occupancy: one grid per time key, looked up by the
    nearest key. State: ``ts_keyframes`` [T] and ``occ.val_grid``."""

    def __init__(self, n_time_keys: int, ts_keyframes=None, device=None,
                 **kw):
        super().__init__(n_time_keys, device=device, **kw)
        ts = torch.linspace(-1.0, 1.0, n_time_keys) if ts_keyframes is None \
            else torch.as_tensor(ts_keyframes, dtype=torch.float32)
        self.register_buffer("ts_keyframes", ts.to(device))

    def time_to_key(self, ts: torch.Tensor) -> torch.Tensor:
        return torch.argmin(torch.abs(ts[..., None] - self.ts_keyframes),
                            dim=-1)
