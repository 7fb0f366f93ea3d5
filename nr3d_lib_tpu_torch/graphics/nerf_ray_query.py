"""NeRF ray-query strategies (port of nr3d_lib_tpu/graphics/nerf_ray_query.py
`_composite`, `nerf_ray_query_march_occ` and
`nerf_ray_query_march_occ_compressed`).

Dense [R, S] sample slabs with validity masks: padding never contributes
(its alpha is forced to 0). The compressed mode compacts the marched slab
row-locally on the occupancy mask before the density query, and again on
the transmittance before the radiance query.

Randomness: a `draw` callable (`graphics.raysample`) hands the march its
[R, S] uniforms, the draw the JAX version takes from `perturb_key`; None
marches at the step midpoints.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nr3d_lib_tpu_torch.graphics import _scan
from nr3d_lib_tpu_torch.graphics import pack_ops as po
from nr3d_lib_tpu_torch.graphics.nerf import ray_alpha_to_vw, tau_to_alpha
from nr3d_lib_tpu_torch.graphics.raysample import Draw

__all__ = ["nerf_ray_query_march_occ", "nerf_ray_query_march_occ_compressed"]

Out = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]


def _march(accel, o_n, d_n, near, far, draw: Optional[Draw]):
    u = None if draw is None else \
        draw((o_n.shape[0], accel.max_steps_per_ray), 0.0, 1.0)
    return accel.ray_march(o_n, d_n, near, far, u=u)


def _composite(t: torch.Tensor, alpha: torch.Tensor, rgb: torch.Tensor,
               ray_mask: torch.Tensor) -> Out:
    vw = ray_alpha_to_vw(alpha)                              # [R,S]
    acc = torch.sum(vw, -1)
    rgb_out = torch.sum(vw[..., None] * rgb, -2)
    depth = torch.sum(vw * t, -1) / torch.clamp(acc, min=1e-10)
    zero = torch.zeros_like(acc)
    rendered = {
        "rgb_volume": torch.where(ray_mask[:, None], rgb_out,
                                  torch.zeros_like(rgb_out)),
        "depth_volume": torch.where(ray_mask, depth, zero),
        "mask_volume": torch.where(ray_mask, acc, zero),
    }
    volume_buffer = {"t": t, "alpha": alpha, "vw": vw, "rgb": rgb,
                     "ray_mask": ray_mask}
    return rendered, volume_buffer


def nerf_ray_query_march_occ(model, accel, space, ray_tested: Dict, *,
                             with_rgb: bool = True,
                             draw: Optional[Draw] = None) -> Out:
    """Occupancy-marched NeRF query over the whole [R, S] slab. model:
    forward_density(x) → {sigma, h} and radiance(x, v, n, h) → rgb, x in
    normalized [-1,1]."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    t, dt, smask = _march(accel, o_n, d_n, near, far, draw)
    x = o_n[:, None, :] + d_n[:, None, :] * t[..., None]      # [R,S,3]
    r, s = t.shape
    den = model.forward_density(x.reshape(r * s, 3))
    sigma = den["sigma"].reshape(r, s)
    alpha = tau_to_alpha(sigma * dt)
    alpha = torch.where(smask & ray_mask[:, None], alpha,
                        torch.zeros_like(alpha))
    if with_rgb:
        v = rays_d[:, None, :].expand(r, s, 3).reshape(r * s, 3)
        rgb = model.radiance(x.reshape(r * s, 3), v, None,
                             den["h"]).reshape(r, s, 3)
    else:
        rgb = torch.zeros((r, s, 3), dtype=t.dtype, device=t.device)
    return _composite(t, alpha, rgb, ray_mask)


def nerf_ray_query_march_occ_compressed(
        model, accel, space, ray_tested: Dict, *,
        compression_factor: float = 0.25, early_stop_eps: float = 1e-4,
        radiance_compression_factor: float = 0.5, with_rgb: bool = True,
        draw: Optional[Draw] = None) -> Out:
    """Occupancy-marched NeRF query with two row-local compactions: the
    marched slab on its occupancy mask before the density query (budget
    compression_factor × S per ray), then on the transmittance before the
    radiance query (budget radiance_compression_factor of the first). A
    ray with more occupied samples than the budget keeps its nearest ones
    (see the JAX docstring)."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    t, dt, smask = _march(accel, o_n, d_n, near, far, draw)
    r, s = t.shape
    smask = smask & ray_mask[:, None]

    # compaction 1: occupancy (per-ray budget)
    b1 = max(int(s * compression_factor), 1)
    (t1, dt1), valid1 = po.dense_to_budgeted([t, dt], smask, b1)
    x1 = o_n[:, None, :] + d_n[:, None, :] * t1[..., None]    # [R,B1,3]
    den = model.forward_density(x1.reshape(r * b1, 3))
    sigma = den["sigma"].reshape(r, b1)
    alpha1 = torch.where(valid1, tau_to_alpha(sigma * dt1),
                         torch.zeros_like(sigma))

    # compaction 2: early termination before the radiance net
    trans = _scan.cumprod(torch.cat(
        [torch.ones_like(alpha1[:, :1]), 1.0 - alpha1[:, :-1]], -1), -1)
    keep2 = valid1 & (alpha1 > 0) & (trans > early_stop_eps)
    b2 = max(int(b1 * radiance_compression_factor), 1)
    (t2, alpha2, h2), valid2 = po.dense_to_budgeted(
        [t1, alpha1, den["h"].reshape(r, b1, -1)], keep2, b2)
    alpha2 = torch.where(valid2, alpha2, torch.zeros_like(alpha2))

    vw = ray_alpha_to_vw(alpha2)
    acc = torch.sum(vw, -1)
    depth = torch.sum(vw * t2, -1) / torch.clamp(acc, min=1e-10)
    zero = torch.zeros_like(acc)
    rendered = {"mask_volume": torch.where(ray_mask, acc, zero),
                "depth_volume": torch.where(ray_mask, depth, zero)}
    if with_rgb:
        x2 = o_n[:, None, :] + d_n[:, None, :] * t2[..., None]
        v2 = rays_d[:, None, :].expand(r, b2, 3)
        rgb = model.radiance(x2.reshape(r * b2, 3), v2.reshape(r * b2, 3),
                             None, h2.reshape(r * b2, -1)).reshape(r, b2, 3)
        rgb_out = torch.sum(vw[..., None] * rgb, -2)
        rendered["rgb_volume"] = torch.where(ray_mask[:, None], rgb_out,
                                             torch.zeros_like(rgb_out))
    # packed view for downstream pack_ops consumers
    ridx2 = torch.where(valid2,
                        torch.arange(r, dtype=torch.int32,
                                     device=t2.device)[:, None],
                        torch.full_like(valid2, r, dtype=torch.int32))
    volume_buffer = {"t_packed": t2.reshape(-1), "ridx": ridx2.reshape(-1),
                     "alpha_packed": alpha2.reshape(-1),
                     "vw_packed": vw.reshape(-1), "ray_mask": ray_mask,
                     "t": t2, "alpha": alpha2, "vw": vw, "valid": valid2,
                     "n_compact": torch.sum(valid2)}
    return rendered, volume_buffer
