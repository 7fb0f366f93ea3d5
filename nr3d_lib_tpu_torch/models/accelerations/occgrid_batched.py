"""Batched and time-keyed occupancy grids (port of nr3d_lib_tpu/models/
accelerations/occgrid_batched.py `OccGridEmaBatched`, `OccGridAccelBatched`,
`OccGridAccelDynamic`, `OccGridAccelStaticAndDynamic`,
`OccGridAccelBatchedDynamic`): B instances, T time keys or B × T (instance,
time key) slots each own a grid, updated together. As in JAX, the
static-and-dynamic pair has no `update_every` of its own (a model over
it reports a lifecycle interval of 1). The marches read every
grid as one table through `occgrid_march_batched_dense` (B5 on the card).

As in `occgrid.py`, the update is split so that a test can hand over the
JAX package's draws: `sample_update_cells` draws n uniform cells and a
point inside each per grid, `apply_update` decays and scatter-maxes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nr3d_lib_tpu_torch.graphics.raymarch import (RaymarchRetBatched,
                                                  occgrid_raymarch_batched)
from nr3d_lib_tpu_torch.models.accelerations.occgrid import (
    OccGridEma, sample_cells_uniform)
from nr3d_lib_tpu_torch.profile import count, profile

__all__ = ["OccGridEmaBatched", "OccGridAccelBatched", "OccGridAccelDynamic",
           "OccGridAccelStaticAndDynamic", "OccGridAccelBatchedDynamic"]

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
    `update_every` steps, and the march of each ray through its grid."""

    def __init__(self, n_batch: int, *, resolution=(32, 32, 32),
                 occ_thre: float = 0.01, ema_decay: float = 0.95,
                 update_every: int = 16, step_size: float = 0.01,
                 max_steps_per_ray: int = 256, device=None, **_):
        super().__init__()
        self.occ = OccGridEmaBatched(n_batch, resolution, occ_thre,
                                     ema_decay, device=device)
        self.update_every = int(update_every)
        self.step_size = float(step_size)
        self.max_steps_per_ray = int(max_steps_per_ray)

    def step(self, it: int, generator: torch.Generator,
             query_fn: QueryFn) -> None:
        """Every `update_every` iterations (it = 0 included), the EMA
        re-query of every grid, in the span `occ.update` with the counts
        `keys` (the grids updated) and `cells` (the cells queried)."""
        if it % self.update_every == 0:
            with profile("occ.update"):
                idx, x = self.occ.sample_update_cells(generator)
                count("keys", idx.shape[0])
                count("cells", idx.shape[0] * idx.shape[1])
                self.occ.apply_update(idx, x, query_fn)

    def collect_samples(self, bidx, x, vals) -> None:
        self.occ.collect_samples(bidx, x, vals)

    def ray_march(self, bidx: torch.Tensor, rays_o: torch.Tensor,
                  rays_d: torch.Tensor, near: torch.Tensor,
                  far: torch.Tensor, u: Optional[torch.Tensor] = None
                  ) -> RaymarchRetBatched:
        """March normalized-space rays, each through its grid bidx [R]
        (bidx < 0: nothing occupied), `max_steps_per_ray` steps of
        `step_size`; `u` [R, S] in [0,1) jitters them (the JAX version's
        `perturb_key` draw), None takes the midpoints."""
        return occgrid_raymarch_batched(
            self.occ.occ(), bidx, rays_o, rays_d, near, far,
            n_steps=self.max_steps_per_ray, step_size=self.step_size, u=u)


def _keyframes(n_time_keys: int, ts_keyframes, device) -> torch.Tensor:
    ts = torch.linspace(-1.0, 1.0, n_time_keys) if ts_keyframes is None \
        else torch.as_tensor(ts_keyframes, dtype=torch.float32)
    return ts.to(device)


def _nearest_key(ts: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Index of the nearest keyframe (the first of a tie, as argmin)."""
    return torch.argmin(torch.abs(ts[..., None] - keys), dim=-1)


class OccGridAccelDynamic(OccGridAccelBatched):
    """Time-keyed occupancy: one grid per time key, looked up by the
    nearest key. State: ``ts_keyframes`` [T] and ``occ.val_grid``."""

    def __init__(self, n_time_keys: int, ts_keyframes=None, device=None,
                 **kw):
        super().__init__(n_time_keys, device=device, **kw)
        self.register_buffer("ts_keyframes",
                             _keyframes(n_time_keys, ts_keyframes, device))

    def time_to_key(self, ts: torch.Tensor) -> torch.Tensor:
        return _nearest_key(ts, self.ts_keyframes)

    def ray_march_at_time(self, ts: torch.Tensor, rays_o, rays_d, near, far,
                          u: Optional[torch.Tensor] = None
                          ) -> RaymarchRetBatched:
        """March each ray through the grid of its nearest time key."""
        return self.ray_march(self.time_to_key(ts), rays_o, rays_d, near,
                              far, u)


class OccGridAccelStaticAndDynamic(nn.Module):
    """A static grid beside the time-keyed grids (`static`: `OccGridEma`,
    `dynamic`: `OccGridAccelDynamic`); occupancy at a time is their
    union."""

    def __init__(self, n_time_keys: int, *, resolution=(32, 32, 32),
                 device=None, **kw):
        super().__init__()
        self.static = OccGridEma(resolution, device=device,
                                 **{k: v for k, v in kw.items()
                                    if k in ("occ_thre", "ema_decay")})
        self.dynamic = OccGridAccelDynamic(n_time_keys, resolution=resolution,
                                           device=device, **kw)

    def occ_at_time(self, key_idx: torch.Tensor) -> torch.Tensor:
        return self.static.occ() | self.dynamic.occ.occ()[key_idx]


class OccGridAccelBatchedDynamic(nn.Module):
    """Instances × time keys occupancy: grid slot b·T + k holds instance b
    at keyframe k, all in one [B·T, r, r, r] EMA-batched grid so an update
    stays one vectorized pass. State: ``occ.val_grid`` and
    ``ts_keyframes``."""

    def __init__(self, n_batch: int, n_time_keys: int, *,
                 resolution=(32, 32, 32), occ_thre: float = 0.01,
                 ema_decay: float = 0.95, update_every: int = 16,
                 step_size: float = 0.01, max_steps_per_ray: int = 256,
                 ts_keyframes=None, device=None, **_):
        super().__init__()
        self.n_batch = int(n_batch)
        self.n_time_keys = int(n_time_keys)
        self.occ = OccGridEmaBatched(self.n_batch * self.n_time_keys,
                                     resolution, occ_thre, ema_decay,
                                     device=device)
        self.register_buffer("ts_keyframes",
                             _keyframes(n_time_keys, ts_keyframes, device))
        self.update_every = int(update_every)
        self.step_size = float(step_size)
        self.max_steps_per_ray = int(max_steps_per_ray)

    def time_to_key(self, ts: torch.Tensor) -> torch.Tensor:
        return _nearest_key(ts, self.ts_keyframes)

    def slot(self, bidx: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        """The grid of instance bidx (clamped at 0) at ts's nearest key."""
        return torch.clamp(bidx, min=0).to(torch.int64) * self.n_time_keys \
            + self.time_to_key(ts)

    def step(self, it: int, generator: torch.Generator,
             query_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                                torch.Tensor]) -> None:
        """Every `update_every` iterations, the EMA re-query of every slot:
        query_fn(x [B·T, n, 3], bidx [B·T, n], ts [B·T, n]) → values."""
        if it % self.update_every != 0:
            return

        def fn(x, slot_idx):
            return query_fn(x, slot_idx // self.n_time_keys,
                            self.ts_keyframes[slot_idx % self.n_time_keys])

        self.occ.step_update(generator, fn)

    def collect_samples(self, bidx: torch.Tensor, ts: torch.Tensor,
                        x: torch.Tensor, vals: torch.Tensor) -> None:
        self.occ.collect_samples(self.slot(bidx, ts), x, vals)

    def ray_march(self, bidx: torch.Tensor, ts: torch.Tensor,
                  rays_o: torch.Tensor, rays_d: torch.Tensor,
                  near: torch.Tensor, far: torch.Tensor,
                  u: Optional[torch.Tensor] = None) -> RaymarchRetBatched:
        """March each ray through its (instance, time key) slot. As the JAX
        version, a ray with bidx < 0 reads instance 0's slot (`slot`
        clamps), and `bidx` of the result is the slot."""
        return occgrid_raymarch_batched(
            self.occ.occ(), self.slot(bidx, ts), rays_o, rays_d, near, far,
            n_steps=self.max_steps_per_ray, step_size=self.step_size, u=u)
