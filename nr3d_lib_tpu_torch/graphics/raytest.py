"""Ray–primitive intersection tests (port of
nr3d_lib_tpu/graphics/raytest.py)."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ray_sphere_intersection", "ray_box_intersection",
           "ray_box_intersection_fast"]


def ray_sphere_intersection(rays_o: torch.Tensor, rays_d: torch.Tensor,
                            radius: float = 1.0, center=None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Ray–sphere: (near, far, hit); near is clamped at 0 (a ray that
    starts inside), and rays without a hit ahead get near = far = 0."""
    o = rays_o if center is None else rays_o - torch.as_tensor(
        center, dtype=rays_o.dtype, device=rays_o.device)
    b = torch.sum(o * rays_d, -1)
    c = torch.sum(o * o, -1) - radius * radius
    a = torch.sum(rays_d * rays_d, -1)
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    near = (-b - sq) / a
    far = (-b + sq) / a
    hit = (disc > 0) & (far > 0)
    zero = torch.zeros_like(near)
    return (torch.where(hit, torch.clamp(near, min=0.0), zero),
            torch.where(hit, far, zero), hit)


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


# the JAX package's alias of the reference's "fast" variant
ray_box_intersection_fast = ray_box_intersection
