"""OccGridAccel — occupancy acceleration for a single space (port of
nr3d_lib_tpu/models/accelerations/occgrid_accel.py: `init`, `step`,
`collect_samples`, `query`, `ray_march`, `try_shrink` and `debug_stats`,
over the EMA grid or, with `use_ema=False`, the getter grid), and
`ray_march_budgeted`: the march with the compressed queries' first
budget compaction, one kernel on a CUDA grid."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.models.accelerations.occgrid import (OccGridEma,
                                                            OccGridGetter)
from nr3d_lib_tpu_torch.ops.occgrid_march import (occgrid_march_budgeted,
                                                  occgrid_march_dense,
                                                  occgrid_query)
from nr3d_lib_tpu_torch.profile import profile

__all__ = ["OccGridAccel"]


class OccGridAccel(nn.Module):
    def __init__(self, *, resolution=(64, 64, 64), occ_thre: float = 0.01,
                 ema_decay: float = 0.95, update_every: int = 16,
                 warmup_iters: int = 256, use_ema: bool = True,
                 step_size: float = 0.01, max_steps_per_ray: int = 512,
                 dt_gamma: float = 0.0, max_step_size: Optional[float] = None,
                 device=None):
        super().__init__()
        if use_ema:
            self.occ = OccGridEma(resolution, occ_thre=occ_thre,
                                  ema_decay=ema_decay, device=device)
        else:
            self.occ = OccGridGetter(resolution, occ_thre=occ_thre,
                                     device=device)
        self.use_ema = use_ema
        self.update_every = int(update_every)
        self.warmup_iters = int(warmup_iters)
        self.step_size = float(step_size)
        self.max_steps_per_ray = int(max_steps_per_ray)
        self.dt_gamma = float(dt_gamma)
        self.max_step_size = max_step_size

    def init(self, query_fn: Optional[Callable] = None) -> None:
        """Populate-time init from a field query: the EMA grid's values,
        or the getter grid's update."""
        if query_fn is None:
            return
        if self.use_ema:
            self.occ.init_from_net(query_fn)
        else:
            self.occ.update(query_fn)

    def step(self, it: int, generator: torch.Generator,
             query_fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """Per-iteration maintenance: every `update_every` iterations
        (it = 0 included, as in JAX), the EMA re-query of the grid, or the
        getter's re-query of every cell (which draws nothing), in the
        span `occ.update`."""
        if it % self.update_every != 0:
            return
        with profile("occ.update"):
            if self.use_ema:
                self.occ.step_update(query_fn, generator)
            else:
                self.occ.update(query_fn)

    def collect_samples(self, x: torch.Tensor, vals: torch.Tensor) -> None:
        """Training-time samples into the EMA grid (the getter ignores
        them)."""
        if self.use_ema:
            self.occ.collect_samples(x, vals)

    def query(self, x: torch.Tensor) -> torch.Tensor:
        """Occupancy at normalized positions x ∈ [-1,1]^3."""
        return occgrid_query(self.occ.occ(), x)

    def ray_march(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                  near: torch.Tensor, far: torch.Tensor,
                  n_steps: Optional[int] = None,
                  u: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """March normalized-space rays → dense (t, dt, mask); `u` [R, S]
        in [0,1) jitters the steps (None: midpoints)."""
        return occgrid_march_dense(
            self.occ.occ(), rays_o, rays_d, near, far,
            n_steps=self.max_steps_per_ray,
            step_size=self.step_size, dt_gamma=self.dt_gamma,
            max_step_size=self.max_step_size, u=u)

    def ray_march_budgeted(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                           near: torch.Tensor, far: torch.Tensor,
                           budget: int, u: Optional[torch.Tensor] = None,
                           ray_mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """March normalized-space rays and keep each ray's first `budget`
        occupied steps → (t, dt, valid) [R, budget]
        (`occgrid_march_budgeted`); `ray_mask` [R] leaves rays empty, `u`
        [R, S] jitters the steps (None: midpoints)."""
        return occgrid_march_budgeted(
            self.occ.occ(), rays_o, rays_d, near, far,
            n_steps=self.max_steps_per_ray,
            step_size=self.step_size, dt_gamma=self.dt_gamma,
            max_step_size=self.max_step_size, u=u, budget=budget,
            ray_mask=ray_mask)

    def try_shrink(self) -> Optional[torch.Tensor]:
        """The EMA grid's tight occupied box [2, 3]; None for the getter."""
        return self.occ.try_shrink() if self.use_ema else None

    def debug_stats(self) -> dict:
        """{occ_ratio: float, n_occupied: int} of the grid (reads back to
        the host)."""
        occ = self.occ.occ()
        return {"occ_ratio": float(occ.to(torch.float32).mean()),
                "n_occupied": int(occ.sum())}
