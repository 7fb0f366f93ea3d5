"""Ray-marching results and the occupancy-grid march entry points (port
of nr3d_lib_tpu/graphics/raymarch.py).

A march gives dense [R, S] slabs and a mask rather than ragged packs;
`to_packed()` compacts them when the packed form is wanted. Perturbation
is a [R, S] uniform `u` handed in (the JAX version's `perturb_key`
draw).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from nr3d_lib_tpu_torch.graphics import pack_ops as po
from nr3d_lib_tpu_torch.ops.occgrid_march import (occgrid_march_batched_dense,
                                                  occgrid_march_dense)

__all__ = ["RaymarchRetSingle", "RaymarchRetBatched", "RaymarchRetForest",
           "occgrid_raymarch", "occgrid_raymarch_batched"]


@dataclass
class RaymarchRetSingle:
    """Dense [R, S] samples: t, dt and their validity."""

    t: torch.Tensor
    dt: torch.Tensor
    mask: torch.Tensor

    @property
    def num_hit_samples(self) -> torch.Tensor:
        return torch.sum(self.mask)

    def positions(self, rays_o: torch.Tensor, rays_d: torch.Tensor
                  ) -> torch.Tensor:
        return rays_o[:, None, :] + rays_d[:, None, :] * self.t[..., None]

    def to_packed(self, capacity: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """→ (t, dt, ridx) compacted into packed buffers."""
        t_flat, ridx = po.dense_to_packed(self.t, self.mask, capacity)
        dt_flat, _ = po.dense_to_packed(self.dt, self.mask, capacity)
        return t_flat, dt_flat, ridx


@dataclass
class RaymarchRetBatched(RaymarchRetSingle):
    bidx: Optional[torch.Tensor] = None


@dataclass
class RaymarchRetForest(RaymarchRetSingle):
    block_inds: Optional[torch.Tensor] = None


def occgrid_raymarch(occ: torch.Tensor, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, near, far, *, n_steps: int = 256,
                     step_size: float = 0.01, dt_gamma: float = 0.0,
                     max_step_size: Optional[float] = None,
                     u: Optional[torch.Tensor] = None) -> RaymarchRetSingle:
    """March normalized-space rays through one grid occ [r0, r1, r2]."""
    t, dt, mask = occgrid_march_dense(
        occ, rays_o, rays_d, torch.as_tensor(near), torch.as_tensor(far),
        n_steps=n_steps, step_size=step_size, dt_gamma=dt_gamma,
        max_step_size=max_step_size, u=u)
    return RaymarchRetSingle(t, dt, mask)


def occgrid_raymarch_batched(occ: torch.Tensor, bidx: torch.Tensor,
                             rays_o: torch.Tensor, rays_d: torch.Tensor,
                             near, far, *, n_steps: int = 256,
                             step_size: float = 0.01, dt_gamma: float = 0.0,
                             max_step_size: Optional[float] = None,
                             u: Optional[torch.Tensor] = None
                             ) -> RaymarchRetBatched:
    """March each ray through its grid occ[bidx] of occ [B, r0, r1, r2]."""
    t, dt, mask = occgrid_march_batched_dense(
        occ, bidx, rays_o, rays_d, torch.as_tensor(near),
        torch.as_tensor(far), n_steps=n_steps, step_size=step_size,
        dt_gamma=dt_gamma, max_step_size=max_step_size, u=u)
    return RaymarchRetBatched(t, dt, mask, bidx)
