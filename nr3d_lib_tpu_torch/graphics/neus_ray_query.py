"""NeuS ray queries (port of nr3d_lib_tpu/graphics/neus_ray_query.py
`_upsample_rounds`, `_final_composite`,
`neus_ray_query_coarse_multi_upsample`,
`neus_ray_query_march_occ_multi_upsample` and
`neus_ray_query_sphere_trace`).

Dense [R, S] slabs: invalid slots carry t=far and sdf=+BIG so their alphas
vanish; merging an upsample round into the slab is a stable per-ray sort
with the validity and cached SDF values carried along as payloads.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from nr3d_lib_tpu_torch.graphics.nerf import ray_alpha_to_vw
from nr3d_lib_tpu_torch.graphics.neus import neus_ray_sdf_to_alpha
from nr3d_lib_tpu_torch.graphics.raysample import (CDF_EPS, Draw,
                                                   batch_sample_pdf,
                                                   batch_sample_step_linear,
                                                   linspace_f32)
from nr3d_lib_tpu_torch.profile import profile

__all__ = ["_upsample_rounds", "_final_composite",
           "neus_ray_query_coarse_multi_upsample",
           "neus_ray_query_march_occ_multi_upsample",
           "neus_ray_query_sphere_trace", "linspace_f32"]

_BIG_SDF = 1e4


def _sort_tvs(t, valid, far, *payloads):
    """Stable sort of the [R, S] slab by t (invalid last, parked at far),
    the validity and each [R, S] payload following."""
    key = torch.where(valid, t, torch.full_like(t, float("inf")))
    key_s, order = torch.sort(key, dim=-1, stable=True)
    v_s = valid.gather(-1, order)
    return (torch.where(v_s, key_s, far[:, None].expand_as(key_s)), v_s,
            *(p.gather(-1, order) for p in payloads))


@torch.no_grad()
def _upsample_rounds(sdf_fn, o_n: torch.Tensor, d_n: torch.Tensor,
                     t: torch.Tensor, valid: torch.Tensor, far: torch.Tensor,
                     inv_s_base: float, upsample_inv_s_factors: Sequence[float],
                     n_importance: int, draw: Optional[Draw] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative NeuS importance sampling. Each round: alphas at growing
    sharpness → CDF sample → merge-sort into the slab. SDF values are cached
    across rounds: only each round's new samples hit the network. `draw`
    perturbs the CDF samples, one draw of [R, n_importance] per round in
    the JAX package's key order; None samples the fixed quantiles.
    Returns (t [R, S + rounds·n_importance] sorted, valid). Sample
    placement carries no gradient, so the rounds run under no_grad (the
    reference's `with torch.no_grad()` around the loop). Each round is a
    span `query.upsample`, each SDF evaluation a span `query.field`."""
    r = t.shape[0]

    def eval_sdf(t_):
        with profile("query.field"):
            x = o_n[:, None, :] + d_n[:, None, :] * t_[..., None]
            return sdf_fn(x.reshape(-1, 3)).reshape(r, t_.shape[1])

    sdf = eval_sdf(t)                       # the one full-slab evaluation
    for factor in upsample_inv_s_factors:
        with profile("query.upsample"):
            t, valid, sdf = _sort_tvs(t, valid, far, sdf)
            sdf_m = torch.where(valid, sdf, torch.full_like(sdf, _BIG_SDF))
            alpha = neus_ray_sdf_to_alpha(sdf_m, inv_s_base * factor,
                                          append_cdf_1=False)      # [R,S-1]
            w = ray_alpha_to_vw(alpha)
            u = None if draw is None else \
                draw((r, n_importance), CDF_EPS, 1.0 - CDF_EPS)
            t_new = batch_sample_pdf(t, w, n_importance, u)        # [R,n_imp]
            sdf_new = eval_sdf(t_new)       # only the new samples
            t = torch.cat([t, t_new], -1)
            valid = torch.cat([valid, torch.ones_like(t_new,
                                                      dtype=torch.bool)], -1)
            sdf = torch.cat([sdf, sdf_new], -1)
    t, valid, _ = _sort_tvs(t, valid, far, sdf)
    return t, valid


def _final_composite(model, o_n: torch.Tensor, d_n: torch.Tensor,
                     rays_d: torch.Tensor, t: torch.Tensor,
                     valid: torch.Tensor, ray_mask: torch.Tensor, inv_s,
                     with_rgb: bool = True
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """The SDF + nablas (+ radiance) query at every slot of the [R, S]
    slab, then the NeuS volume composite; invalid slots and masked rays
    get alpha 0."""
    r, s = t.shape
    x = o_n[:, None, :] + d_n[:, None, :] * t[..., None]
    v = rays_d[:, None, :].expand(r, s, 3).reshape(r * s, 3)
    out = model(x.reshape(r * s, 3), v, with_rgb=with_rgb, with_nablas=True)
    sdf = torch.where(valid, out["sdf"].reshape(r, s),
                      torch.full_like(t, _BIG_SDF))
    alpha = neus_ray_sdf_to_alpha(sdf, inv_s, append_cdf_1=True)   # [R,S]
    alpha = torch.where(valid & ray_mask[:, None], alpha,
                        torch.zeros_like(alpha))
    vw = ray_alpha_to_vw(alpha)
    acc = torch.sum(vw, -1)
    zero_r = torch.zeros_like(acc)
    rendered = {"mask_volume": torch.where(ray_mask, acc, zero_r)}
    if with_rgb:
        rgb = torch.sum(vw[..., None] * out["rgb"].reshape(r, s, 3), -2)
        rendered["rgb_volume"] = torch.where(ray_mask[:, None], rgb,
                                             torch.zeros_like(rgb))
    depth = torch.sum(vw * t, -1) / torch.clamp(acc, min=1e-10)
    rendered["depth_volume"] = torch.where(ray_mask, depth, zero_r)
    nablas = out["nablas"].reshape(r, s, 3)
    n_img = torch.sum(vw[..., None] * nablas, -2)
    rendered["normals_volume"] = torch.where(ray_mask[:, None], n_img,
                                             torch.zeros_like(n_img))
    volume_buffer = {"t": t, "alpha": alpha, "vw": vw, "sdf": sdf,
                     "ray_mask": ray_mask, "valid": valid, "nablas": nablas,
                     "x": x}
    return rendered, volume_buffer


def neus_ray_query_coarse_multi_upsample(
        model, space, ray_tested: Dict, *, n_coarse: int = 64,
        upsample_inv_s_factors: Sequence[float] = (1.0, 4.0, 16.0),
        n_importance: int = 32, upsample_inv_s: float = 64.0,
        with_rgb: bool = True, draw: Optional[Draw] = None
        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Coarse stratified samples, then iterative NeuS upsampling, then the
    final query over the whole slab (n_coarse + rounds·n_importance
    samples a ray). `draw` perturbs the coarse samples ([R, n_coarse] in
    [0,1)) and then each upsample round, the order in which the JAX
    version splits its key; None renders at the bin midpoints and fixed
    quantiles. Only the final query and inv_s carry gradients: the
    sampling runs under no_grad."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    u = None if draw is None else draw((rays_o.shape[0], n_coarse), 0.0,
                                       1.0)
    t, _ = batch_sample_step_linear(near, far, n_coarse, u)
    valid = torch.ones_like(t, dtype=torch.bool)

    def sdf_fn(x):
        return model.forward_sdf(x)["sdf"]

    t, valid = _upsample_rounds(sdf_fn, o_n, d_n, t, valid, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, draw)
    return _final_composite(model, o_n, d_n, rays_d, t, valid, ray_mask,
                            model.forward_inv_s(), with_rgb)


def neus_ray_query_march_occ_multi_upsample(
        model, accel, space, ray_tested: Dict, *,
        upsample_inv_s_factors: Sequence[float] = (1.0, 4.0, 16.0),
        n_importance: int = 32, upsample_inv_s: float = 64.0,
        with_rgb: bool = True, draw: Optional[Draw] = None
        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Occupancy-marched, then iteratively upsampled, then the final query
    over the whole slab (S_max + rounds·n_importance samples a ray). The
    marched mask goes into the rounds as it is: `_final_composite` masks
    the rays. `draw` perturbs the march ([R, S_max] in [0,1)) and then
    each upsample round, the order in which the JAX version splits its
    key; None marches at the step midpoints and samples the fixed
    quantiles. Only the final query and inv_s carry gradients."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    u = None if draw is None else \
        draw((rays_o.shape[0], accel.max_steps_per_ray), 0.0, 1.0)
    t, _, smask = accel.ray_march(o_n, d_n, near, far, u=u)

    def sdf_fn(x):
        return model.forward_sdf(x)["sdf"]

    t, valid = _upsample_rounds(sdf_fn, o_n, d_n, t, smask, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, draw)
    return _final_composite(model, o_n, d_n, rays_d, t, valid, ray_mask,
                            model.forward_inv_s(), with_rgb)


def neus_ray_query_sphere_trace(
        model, accel, space, ray_tested: Dict, *,
        n_band: int = 16, band_sigma: float = 3.0,
        n_tail: int = 8, tail_span: float = 0.1,
        hit_threshold: float = 5e-4, max_iters: int = 64,
        distance_scale: float = 1.0,
        with_rgb: bool = True, draw: Optional[Draw] = None
        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Sphere-trace each ray to the SDF's zero crossing (seeded from the
    accel's occupancy grid), place `n_band` samples over ±band_sigma/inv_s
    around the hit and `n_tail` behind it, and volume-render them with the
    NeuS estimator; a missed ray keeps zero alpha. The band's width
    carries inv_s's gradient (not detached, as in JAX). `draw` jitters
    the band, then the tail (U[−0.5, 0.5) each, the JAX version's key
    order); None places them on the grid. Adds `depth_surface`, and the
    trace's results to the volume buffer (`trace_iters`: its iterations,
    see `graphics.sphere_trace`)."""
    from nr3d_lib_tpu_torch.graphics.sphere_trace import sphere_trace

    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)

    def sdf_fn(x):
        return model.forward_sdf(x)["sdf"]

    occ = accel.occ.occ() if accel is not None else None
    tr = sphere_trace(o_n, d_n, near, far, sdf_fn,
                      distance_scale=distance_scale,
                      hit_threshold=hit_threshold, max_iters=max_iters,
                      occ_grid=occ)
    inv_s = model.forward_inv_s()
    half_band = band_sigma / torch.clamp(inv_s, min=1e-6)

    # the band is centred at the hit; a missed ray parks its samples past
    # far (its alpha is masked below), so the shapes stay fixed
    t_hit = torch.where(tr["hit"], tr["t"], far)
    dev = t_hit.device
    u = linspace_f32(-1.0, 1.0, n_band, dev)
    t_band = t_hit[:, None] + half_band * u[None, :]
    span = (tail_span * (far - t_hit))[:, None]
    t_tail = t_hit[:, None] + half_band + \
        span * linspace_f32(0.1, 1.0, n_tail, dev)[None, :]
    if draw is not None:
        t_band = t_band + draw(tuple(t_band.shape), -0.5, 0.5) * \
            (2 * half_band / n_band)
        t_tail = t_tail + draw(tuple(t_tail.shape), -0.5, 0.5) * \
            span / n_tail
    t = torch.sort(torch.cat([t_band, t_tail], -1), -1).values
    t = torch.clamp(t, near[:, None], far[:, None])
    valid = tr["hit"][:, None].expand_as(t)
    rendered, vb = _final_composite(model, o_n, d_n, rays_d, t, valid,
                                    ray_mask, inv_s, with_rgb)
    vb.update(t_hit=t_hit, hit=tr["hit"], trace_sdf=tr["sdf"],
              trace_status=tr["status"], trace_iters=tr["iters"])
    rendered["depth_surface"] = torch.where(ray_mask & tr["hit"], t_hit,
                                            torch.zeros_like(t_hit))
    return rendered, vb
