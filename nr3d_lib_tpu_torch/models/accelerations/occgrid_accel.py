"""OccGridAccel — occupancy acceleration for a single space (port of
nr3d_lib_tpu/models/accelerations/occgrid_accel.py: `init` and
`ray_march`; the training-time `step` and `collect_samples` are slice 2)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.models.accelerations.occgrid import OccGridEma
from nr3d_lib_tpu_torch.ops.occgrid_march import occgrid_march_dense

__all__ = ["OccGridAccel"]


class OccGridAccel(nn.Module):
    def __init__(self, *, resolution=(64, 64, 64), occ_thre: float = 0.01,
                 step_size: float = 0.01, max_steps_per_ray: int = 512,
                 dt_gamma: float = 0.0, max_step_size: Optional[float] = None,
                 device=None):
        super().__init__()
        self.occ = OccGridEma(resolution, occ_thre=occ_thre, device=device)
        self.step_size = float(step_size)
        self.max_steps_per_ray = int(max_steps_per_ray)
        self.dt_gamma = float(dt_gamma)
        self.max_step_size = max_step_size

    def init(self, query_fn: Optional[Callable] = None) -> None:
        """Populate-time init from a field query."""
        if query_fn is not None:
            self.occ.init_from_net(query_fn)

    def ray_march(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                  near: torch.Tensor, far: torch.Tensor,
                  n_steps: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """March normalized-space rays → dense (t, dt, mask)."""
        return occgrid_march_dense(
            self.occ.occ(), rays_o, rays_d, near, far,
            n_steps=n_steps or self.max_steps_per_ray,
            step_size=self.step_size, dt_gamma=self.dt_gamma,
            max_step_size=self.max_step_size)
