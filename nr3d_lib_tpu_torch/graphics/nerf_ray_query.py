"""NeRF ray-query strategies (port of nr3d_lib_tpu/graphics/nerf_ray_query.py
`_composite`, `nerf_ray_query_march_occ`,
`nerf_ray_query_march_occ_compressed`,
`nerf_ray_query_march_occ_multi_upsample_compressed` and
`nerf_ray_query_fixed`).

Dense [R, S] sample slabs with validity masks: padding never contributes
(its alpha is forced to 0). The compressed modes keep each ray's first
occupied steps as they march (`OccGridAccel.ray_march_budgeted`: one
kernel on the card, no [R, S] slab) before the density query, and
compact again on the transmittance before the radiance query.

Randomness: a `draw` callable (`graphics.raysample`) hands the march its
[R, S] uniforms, the draw the JAX version takes from `perturb_key`; None
marches at the step midpoints. The fixed query draws its stratified
jitter the same way, and the multi-upsample query its coarse jitter and
its CDF quantiles after the march's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nr3d_lib_tpu_torch.graphics import _scan
from nr3d_lib_tpu_torch.graphics import pack_ops as po
from nr3d_lib_tpu_torch.graphics.nerf import ray_alpha_to_vw, tau_to_alpha
from nr3d_lib_tpu_torch.graphics.neus_ray_query import _sort_tvs
from nr3d_lib_tpu_torch.graphics.raysample import (CDF_EPS, Draw,
                                                   batch_sample_cdf,
                                                   batch_sample_step_linear)
from nr3d_lib_tpu_torch.profile import profile

__all__ = ["nerf_ray_query_march_occ", "nerf_ray_query_march_occ_compressed",
           "nerf_ray_query_march_occ_multi_upsample_compressed",
           "nerf_ray_query_fixed"]

Out = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]


def _march(accel, o_n, d_n, near, far, draw: Optional[Draw]):
    u = None if draw is None else \
        draw((o_n.shape[0], accel.max_steps_per_ray), 0.0, 1.0)
    return accel.ray_march(o_n, d_n, near, far, u=u)


def _march_budgeted(accel, o_n, d_n, near, far, ray_mask, budget: int,
                    draw: Optional[Draw]):
    """The march and compaction 1: each ray's first `budget` occupied
    steps → (t, dt, valid) [R, budget]."""
    u = None if draw is None else \
        draw((o_n.shape[0], accel.max_steps_per_ray), 0.0, 1.0)
    return accel.ray_march_budgeted(o_n, d_n, near, far, budget, u=u,
                                    ray_mask=ray_mask)


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
    march keeps each ray's first occupied samples (budget
    compression_factor × S per ray) before the density query, then the
    transmittance compaction before the radiance query (budget
    radiance_compression_factor of the first). A ray with more occupied
    samples than the budget keeps its nearest ones (see the JAX
    docstring)."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)

    # the march and compaction 1: occupancy (per-ray budget)
    b1 = max(int(accel.max_steps_per_ray * compression_factor), 1)
    with profile("query.march"):
        t1, dt1, valid1 = _march_budgeted(accel, o_n, d_n, near, far,
                                          ray_mask, b1, draw)
    r = t1.shape[0]
    x1 = o_n[:, None, :] + d_n[:, None, :] * t1[..., None]    # [R,B1,3]
    with profile("query.field"):
        den = model.forward_density(x1.reshape(r * b1, 3))
    sigma = den["sigma"].reshape(r, b1)
    alpha1 = torch.where(valid1, tau_to_alpha(sigma * dt1),
                         torch.zeros_like(sigma))

    return _radiance_compressed(model, o_n, d_n, rays_d, t1, alpha1,
                                den["h"].reshape(r, b1, -1), valid1,
                                ray_mask, early_stop_eps,
                                max(int(b1 * radiance_compression_factor),
                                    1), with_rgb)


def _radiance_compressed(model, o_n, d_n, rays_d, t1, alpha1, h1, valid1,
                         ray_mask, early_stop_eps: float, b2: int,
                         with_rgb: bool) -> Out:
    """Compaction 2 and the composite: keep each ray's samples ahead of
    transmittance early_stop_eps (at most b2), query the radiance there
    only, and composite; the volume buffer also holds the packed view."""
    r = t1.shape[0]
    trans = _scan.cumprod(torch.cat(
        [torch.ones_like(alpha1[:, :1]), 1.0 - alpha1[:, :-1]], -1), -1)
    keep2 = valid1 & (alpha1 > 0) & (trans > early_stop_eps)
    with profile("query.compact"):
        (t2, alpha2, h2), valid2 = po.dense_to_budgeted(
            [t1, alpha1, h1], keep2, b2)
    alpha2 = torch.where(valid2, alpha2, torch.zeros_like(alpha2))
    if with_rgb:
        with profile("query.field"):
            x2 = o_n[:, None, :] + d_n[:, None, :] * t2[..., None]
            v2 = rays_d[:, None, :].expand(r, b2, 3)
            rgb = model.radiance(x2.reshape(r * b2, 3),
                                 v2.reshape(r * b2, 3), None,
                                 h2.reshape(r * b2, -1)).reshape(r, b2, 3)

    with profile("query.composite"):
        vw = ray_alpha_to_vw(alpha2)
        acc = torch.sum(vw, -1)
        depth = torch.sum(vw * t2, -1) / torch.clamp(acc, min=1e-10)
        zero = torch.zeros_like(acc)
        rendered = {"mask_volume": torch.where(ray_mask, acc, zero),
                    "depth_volume": torch.where(ray_mask, depth, zero)}
        if with_rgb:
            rgb_out = torch.sum(vw[..., None] * rgb, -2)
            rendered["rgb_volume"] = torch.where(ray_mask[:, None], rgb_out,
                                                 torch.zeros_like(rgb_out))
        # packed view for downstream pack_ops consumers
        ridx2 = torch.where(valid2,
                            torch.arange(r, dtype=torch.int32,
                                         device=t2.device)[:, None],
                            torch.full_like(valid2, r, dtype=torch.int32))
        volume_buffer = {"t_packed": t2.reshape(-1),
                         "ridx": ridx2.reshape(-1),
                         "alpha_packed": alpha2.reshape(-1),
                         "vw_packed": vw.reshape(-1), "ray_mask": ray_mask,
                         "t": t2, "alpha": alpha2, "vw": vw,
                         "valid": valid2, "n_compact": torch.sum(valid2)}
    return rendered, volume_buffer


def nerf_ray_query_march_occ_multi_upsample_compressed(
        model, accel, space, ray_tested: Dict, *,
        compression_factor: float = 0.25, n_fine: int = 32,
        n_coarse: int = 0, early_stop_eps: float = 1e-4,
        radiance_compression_factor: float = 0.5, with_rgb: bool = True,
        draw: Optional[Draw] = None) -> Out:
    """Occupancy-marched NeRF query with an inverse-CDF upsample round
    between the march and the compaction:
      1. march, compact to B1 = compression_factor × S samples a ray,
         with `n_coarse` > 0 uniform coarse samples joined to them;
      2. the density at the B1 candidates under no_grad → a per-ray CDF
         of their alphas → `n_fine` fine depths;
      3. merge-sort fine and candidate depths, take dt to the next one (the
         last to far), query the density again, compact on the
         transmittance (radiance_compression_factor of the merged count)
         before the radiance query.
    `draw` hands out the march's [R, S] uniforms, then the coarse
    samples' [R, n_coarse] (JAX draws these from the march's key again;
    the port draws them afresh, ROADMAP.md §C), then the CDF quantiles
    [R, n_fine] in [eps, 1−eps). None renders unperturbed."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)

    # the march and compaction 1: occupancy (per-ray budget), + the
    # optional coarse union
    b1 = max(int(accel.max_steps_per_ray * compression_factor), 1)
    with profile("query.march"):
        t1, _, valid1 = _march_budgeted(accel, o_n, d_n, near, far,
                                        ray_mask, b1, draw)
    r = t1.shape[0]
    if n_coarse > 0:
        u = None if draw is None else draw((r, n_coarse), 0.0, 1.0)
        t_c, _ = batch_sample_step_linear(near, far, n_coarse, u)
        t1 = torch.cat([t1, t_c], -1)
        valid1 = torch.cat([valid1, ray_mask[:, None].expand_as(t_c)], -1)
        b1 = b1 + n_coarse
    t1, valid1 = _sort_tvs(t1, valid1, far)

    def density_at(tq):
        x = o_n[:, None, :] + d_n[:, None, :] * tq[..., None]
        return model.forward_density(x.reshape(-1, 3))

    # the upsample round: no gradient reaches the sample placement
    with torch.no_grad():
        sigma_u = density_at(t1)["sigma"].reshape(r, b1)
        dt_u = torch.clamp(torch.diff(t1, dim=-1, append=far[:, None]),
                           min=0.0)
        alpha_u = torch.where(valid1, tau_to_alpha(sigma_u * dt_u),
                              torch.zeros_like(sigma_u))
        cdf = _scan.cumsum(alpha_u, -1)
        cdf = cdf / torch.clamp(cdf[:, -1:], min=1e-5)
        u = None if draw is None else \
            draw((r, n_fine), CDF_EPS, 1.0 - CDF_EPS)
        t_fine = batch_sample_cdf(t1, cdf, n_fine, u)             # [R, F]
        t_fine = torch.clamp(t_fine, near[:, None], far[:, None])

    # merge fine + candidates, re-difference, the final density
    t_all, valid_all = _sort_tvs(
        torch.cat([t1, t_fine], -1),
        torch.cat([valid1, ray_mask[:, None].expand_as(t_fine)], -1), far)
    n_all = b1 + n_fine
    dt_all = torch.clamp(torch.diff(t_all, dim=-1, append=far[:, None]),
                         min=0.0)
    den = density_at(t_all)
    sigma = den["sigma"].reshape(r, n_all)
    alpha1 = torch.where(valid_all, tau_to_alpha(sigma * dt_all),
                         torch.zeros_like(sigma))
    return _radiance_compressed(model, o_n, d_n, rays_d, t_all, alpha1,
                                den["h"].reshape(r, n_all, -1), valid_all,
                                ray_mask, early_stop_eps,
                                max(int(n_all * radiance_compression_factor),
                                    1), with_rgb)


def nerf_ray_query_fixed(model, space, ray_tested: Dict, *,
                         n_samples: int = 128,
                         draw: Optional[Draw] = None) -> Out:
    """Fixed-count stratified sampling without acceleration: `n_samples`
    bins between near and far, a density and a radiance query at every
    sample. `draw` jitters each bin ([R, n_samples] in [0,1), the JAX
    version's `perturb_key` draw); None samples the bin midpoints. A plain
    function, as in JAX: `LoTDNeRFModel` has no such query mode."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    u = None if draw is None else draw((rays_o.shape[0], n_samples), 0.0,
                                       1.0)
    t, dt = batch_sample_step_linear(near, far, n_samples, u)
    x = o_n[:, None, :] + d_n[:, None, :] * t[..., None]
    r, s = t.shape
    den = model.forward_density(x.reshape(r * s, 3))
    sigma = den["sigma"].reshape(r, s)
    alpha = tau_to_alpha(sigma * dt)
    alpha = torch.where(ray_mask[:, None], alpha, torch.zeros_like(alpha))
    v = rays_d[:, None, :].expand(r, s, 3).reshape(r * s, 3)
    rgb = model.radiance(x.reshape(r * s, 3), v, None,
                         den["h"]).reshape(r, s, 3)
    return _composite(t, alpha, rgb, ray_mask)
