"""Ray–box intersection (port of nr3d_lib_tpu/graphics/raytest.py
`ray_box_intersection`)."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ray_box_intersection"]


def ray_box_intersection(rays_o: torch.Tensor, rays_d: torch.Tensor,
                         aabb_min, aabb_max, t_min: float = 0.0,
                         t_max: float = 1e10
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab-method ray–AABB: (t_near, t_far, hit); misses get 0, 0."""
    aabb_min = torch.as_tensor(aabb_min, dtype=rays_o.dtype,
                               device=rays_o.device)
    aabb_max = torch.as_tensor(aabb_max, dtype=rays_o.dtype,
                               device=rays_o.device)
    tiny = torch.where(rays_d >= 0, 1e-12, -1e-12).to(rays_d.dtype)
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-12, tiny, rays_d)
    t0 = (aabb_min - rays_o) * inv_d
    t1 = (aabb_max - rays_o) * inv_d
    t_small = torch.minimum(t0, t1)
    t_big = torch.maximum(t0, t1)
    near = torch.clamp(t_small.amax(-1), min=t_min)
    far = torch.clamp(t_big.amin(-1), max=t_max)
    hit = near < far
    zero = torch.zeros_like(near)
    return torch.where(hit, near, zero), torch.where(hit, far, zero), hit
