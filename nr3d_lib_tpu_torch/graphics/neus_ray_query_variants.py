"""NeuS ray-query variants (port of nr3d_lib_tpu/graphics/
neus_ray_query_variants.py): the compressed query
(`neus_ray_query_march_occ_multi_upsample_compressed`: march + upsample,
then compact each ray to its surviving samples before the RGB/nablas
query, which then touches ~compression_factor × fewer samples) and the
time-conditioned query (`neus_ray_query_dynamic`: linear coarse samples +
upsample, every query carrying the ray's timestamp), and the latent-conditioned batched
queries (`neus_ray_query_batched`: each ray renders its instance bidx,
with the per-ray latent or, `per_instance_z`, the instance table and
bidx; `neus_ray_query_batched_dynamic`: latent and timestamp per ray).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from nr3d_lib_tpu_torch.graphics import _scan
from nr3d_lib_tpu_torch.graphics import pack_ops as po
from nr3d_lib_tpu_torch.graphics.nerf import ray_alpha_to_vw
from nr3d_lib_tpu_torch.graphics.neus import neus_ray_sdf_to_alpha
from nr3d_lib_tpu_torch.graphics.neus_ray_query import _upsample_rounds
from nr3d_lib_tpu_torch.graphics.raysample import (Draw,
                                                   batch_sample_step_linear)
from nr3d_lib_tpu_torch.profile import count, profile

__all__ = ["neus_ray_query_march_occ_multi_upsample_compressed",
           "neus_ray_query_dynamic", "neus_ray_query_batched",
           "neus_ray_query_batched_dynamic"]

_BIG_SDF = 1e4


def neus_ray_query_march_occ_multi_upsample_compressed(
        model, accel, space, ray_tested: Dict, *,
        upsample_inv_s_factors: Sequence[float] = (1.0, 4.0, 16.0),
        n_importance: int = 32, upsample_inv_s: float = 64.0,
        compression_factor: float = 0.25, early_stop_eps: float = 1e-4,
        march_budget_factor: float = 1.0, with_rgb: bool = True,
        draw: Optional[Draw] = None
        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``march_budget_factor`` < 1 keeps factor × S_max slots per ray as
    the march goes (`OccGridAccel.ray_march_budgeted`: one kernel on the
    card) before the upsample loop; a ray with more occupied samples than
    that keeps its nearest ones (see the JAX docstring).

    ``draw`` (see `graphics.raysample`) perturbs the samples for training:
    one [R, S_max] draw jitters the march, then one draw per upsample
    round, the order in which the JAX version splits its key. None
    renders unperturbed. Only the final query and inv_s carry gradients:
    the sampling rounds and the early-stop SDF pass run under no_grad."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    with profile("query.march"):
        u_march = None if draw is None else \
            draw((rays_o.shape[0], accel.max_steps_per_ray), 0.0, 1.0)
        if march_budget_factor < 1.0:
            b0 = max(int(accel.max_steps_per_ray * march_budget_factor), 1)
            t, _, smask = accel.ray_march_budgeted(o_n, d_n, near, far, b0,
                                                   u=u_march)
        else:
            t, _, smask = accel.ray_march(o_n, d_n, near, far, u=u_march)

    def sdf_fn(x):
        return model.forward_sdf(x)["sdf"]

    t, valid = _upsample_rounds(sdf_fn, o_n, d_n, t, smask, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, draw)
    r, s = t.shape
    inv_s = model.forward_inv_s()
    with torch.no_grad():
        # cheap SDF-only pass → alphas → keep-mask (early termination)
        big = torch.full_like(t, _BIG_SDF)
        x = o_n[:, None, :] + d_n[:, None, :] * t[..., None]
        with profile("query.field"):
            sdf = sdf_fn(x.reshape(r * s, 3))
        sdf = torch.where(valid, sdf.reshape(r, s), big)
        alpha = neus_ray_sdf_to_alpha(sdf, inv_s, append_cdf_1=True)
        alpha = torch.where(valid & ray_mask[:, None], alpha,
                            torch.zeros_like(alpha))
        trans_excl = _scan.cumprod(
            torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]],
                      -1), -1)
        keep = valid & (trans_excl > early_stop_eps) & (alpha > 0)

    b1 = max(int(s * compression_factor), 1)
    with profile("query.compact"):
        (t_b,), valid_b = po.dense_to_budgeted([t], keep, b1)
    x_b = o_n[:, None, :] + d_n[:, None, :] * t_b[..., None]   # [R,B,3]
    v_b = rays_d[:, None, :].expand(r, b1, 3)

    with profile("query.field"):
        out = model(x_b.reshape(r * b1, 3), v_b.reshape(r * b1, 3),
                    with_rgb=with_rgb, with_nablas=True)
    with profile("query.composite"):
        return _compressed_composite(out, t_b, valid_b, ray_mask, inv_s,
                                     with_rgb)


def _compressed_composite(out: Dict, t_b: torch.Tensor,
                          valid_b: torch.Tensor, ray_mask: torch.Tensor,
                          inv_s, with_rgb: bool) -> Tuple[Dict, Dict]:
    """The NeuS composite of the compressed query's final [R, B] slab and
    its volume buffer (dense and packed)."""
    r, b1 = t_b.shape
    sdf_b = torch.where(valid_b, out["sdf"].reshape(r, b1),
                        torch.full_like(t_b, _BIG_SDF))
    alpha_b = torch.where(valid_b,
                          neus_ray_sdf_to_alpha(sdf_b, inv_s,
                                                append_cdf_1=True),
                          torch.zeros_like(t_b))
    vw = ray_alpha_to_vw(alpha_b)
    acc = torch.sum(vw, -1)
    depth = torch.sum(vw * t_b, -1) / torch.clamp(acc, min=1e-10)
    zero_r = torch.zeros_like(acc)
    rendered = {"mask_volume": torch.where(ray_mask, acc, zero_r),
                "depth_volume": torch.where(ray_mask, depth, zero_r)}
    if with_rgb:
        rgb = out["rgb"].reshape(r, b1, 3)
        rendered["rgb_volume"] = torch.where(
            ray_mask[:, None], torch.sum(vw[..., None] * rgb, -2),
            torch.zeros_like(rgb[:, 0]))
    nablas = out["nablas"].reshape(r, b1, 3)
    nrm = torch.sum(vw[..., None] * nablas, -2)
    rendered["normals_volume"] = torch.where(ray_mask[:, None], nrm,
                                             torch.zeros_like(nrm))
    ridx = torch.where(valid_b,
                       torch.arange(r, dtype=torch.int32,
                                    device=t_b.device)[:, None],
                       torch.full_like(valid_b, r, dtype=torch.int32)
                       ).reshape(-1)
    vb = {"t_packed": t_b.reshape(-1), "ridx": ridx,
          "alpha_packed": alpha_b.reshape(-1), "vw_packed": vw.reshape(-1),
          "nablas_packed": nablas.reshape(-1, 3),
          "t": t_b, "alpha": alpha_b, "vw": vw, "valid": valid_b,
          "ray_mask": ray_mask, "n_compact": torch.sum(valid_b)}
    return rendered, vb


def neus_ray_query_dynamic(model, space, ray_tested: Dict, ts: torch.Tensor,
                           *, n_coarse: int = 64,
                           upsample_inv_s_factors: Sequence[float] = (1.0,
                                                                      4.0),
                           n_importance: int = 16,
                           upsample_inv_s: float = 64.0,
                           with_rgb: bool = True, draw: Optional[Draw] = None
                           ) -> Tuple[Dict, Dict]:
    """Time-conditioned NeuS query: ts [R] per ray; every SDF and radiance
    query carries the ray's timestamp. ``draw`` perturbs the coarse
    samples ([R, n_coarse] in [0,1)) and then each upsample round, the
    order in which the JAX version splits its key; None renders at the
    bin midpoints and fixed quantiles. Only the final query and inv_s
    carry gradients: the sampling runs under no_grad. Its final pass is a
    span `query.field`, its composite `query.composite`, and it counts
    its final samples (rays × slots) as `samples` on the span open around
    it (the model's `query`)."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = space.normalize_rays(rays_o, rays_d)
    r = rays_o.shape[0]
    u = None if draw is None else draw((r, n_coarse), 0.0, 1.0)
    t, _ = batch_sample_step_linear(near, far, n_coarse, u)
    valid = torch.ones_like(t, dtype=torch.bool)

    def sdf_fn_flat(x):
        ts_rep = torch.repeat_interleave(ts, x.shape[0] // r)
        return model.implicit_surface.forward_sdf(x, ts_rep)["sdf"]

    t, valid = _upsample_rounds(sdf_fn_flat, o_n, d_n, t, valid, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, draw)
    s = t.shape[1]
    count("samples", r * s)
    x = (o_n[:, None, :] + d_n[:, None, :] * t[..., None]).reshape(r * s, 3)
    ts_rep = torch.repeat_interleave(ts, s)
    v = rays_d[:, None, :].expand(r, s, 3).reshape(r * s, 3)
    with profile("query.field"):
        out = model(x, v, ts_rep, with_rgb=with_rgb)
    with profile("query.composite"):
        sdf = torch.where(valid, out["sdf"].reshape(r, s),
                          torch.full_like(t, _BIG_SDF))
        alpha = neus_ray_sdf_to_alpha(sdf, model.forward_inv_s(),
                                      append_cdf_1=True)
        alpha = torch.where(valid & ray_mask[:, None], alpha,
                            torch.zeros_like(alpha))
        vw = ray_alpha_to_vw(alpha)
        acc = torch.sum(vw, -1)
        zero_r = torch.zeros_like(acc)
        depth = torch.sum(vw * t, -1) / torch.clamp(acc, min=1e-10)
        rendered = {"mask_volume": torch.where(ray_mask, acc, zero_r),
                    "depth_volume": torch.where(ray_mask, depth, zero_r)}
        if with_rgb:
            rgb = torch.sum(vw[..., None] * out["rgb"].reshape(r, s, 3), -2)
            rendered["rgb_volume"] = torch.where(ray_mask[:, None], rgb,
                                                 torch.zeros_like(rgb))
    return rendered, {"t": t, "alpha": alpha, "vw": vw,
                      "nablas": out["nablas"].reshape(r, s, 3)}


def _normalize_batched(space, rays_o, rays_d, bidx):
    """A batched space (one with `n_batch`) normalizes each ray by its
    instance's box; any other space by its one box."""
    if getattr(space, "n_batch", None):
        return space.normalize_rays(rays_o, rays_d, bidx)
    return space.normalize_rays(rays_o, rays_d)


def _batched_composite(out: Dict, t: torch.Tensor, valid: torch.Tensor,
                       ray_mask: torch.Tensor, bidx: torch.Tensor, inv_s,
                       with_rgb: bool) -> Tuple[Dict, Dict]:
    """The NeuS volume composite of a batched query's final slab; slots of
    invalid samples, masked rays and rays with bidx < 0 get alpha 0."""
    r, s = t.shape
    sdf = torch.where(valid, out["sdf"].reshape(r, s),
                      torch.full_like(t, _BIG_SDF))
    alpha = neus_ray_sdf_to_alpha(sdf, inv_s, append_cdf_1=True)
    alpha = torch.where(valid & ray_mask[:, None] & (bidx >= 0)[:, None],
                        alpha, torch.zeros_like(alpha))
    vw = ray_alpha_to_vw(alpha)
    acc = torch.sum(vw, -1)
    zero_r = torch.zeros_like(acc)
    depth = torch.sum(vw * t, -1) / torch.clamp(acc, min=1e-10)
    rendered = {"mask_volume": torch.where(ray_mask, acc, zero_r),
                "depth_volume": torch.where(ray_mask, depth, zero_r)}
    if with_rgb:
        rgb = torch.sum(vw[..., None] * out["rgb"].reshape(r, s, 3), -2)
        rendered["rgb_volume"] = torch.where(ray_mask[:, None], rgb,
                                             torch.zeros_like(rgb))
    vb = {"t": t, "alpha": alpha, "vw": vw}
    if out.get("nablas") is not None:
        vb["nablas"] = out["nablas"].reshape(r, s, 3)
    return rendered, vb


def neus_ray_query_batched(model, space, ray_tested: Dict, z: torch.Tensor,
                           bidx: torch.Tensor, *, n_coarse: int = 64,
                           upsample_inv_s_factors: Sequence[float] = (1.0,
                                                                      4.0),
                           n_importance: int = 16,
                           upsample_inv_s: float = 64.0,
                           per_instance_z: bool = False,
                           with_rgb: bool = True, draw: Optional[Draw] = None
                           ) -> Tuple[Dict, Dict]:
    """Latent-conditioned batched query: z [B, z_dim] the instance table,
    bidx [R] each ray's instance (clamped at 0 for the lookup; a ray with
    bidx < 0 renders empty), so rays of several instances render in one
    pass. The field is called as (x, v, z_rep) with the ray's latent per
    point, or with `per_instance_z` as (x, v, z, bidx_rep): the style
    family grows its parameters once per instance, not per point.
    ``draw`` perturbs the samples as in `neus_ray_query_dynamic`."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = _normalize_batched(space, rays_o, rays_d, bidx)
    r = rays_o.shape[0]
    u = None if draw is None else draw((r, n_coarse), 0.0, 1.0)
    t, _ = batch_sample_step_linear(near, far, n_coarse, u)
    valid = torch.ones_like(t, dtype=torch.bool)
    b0 = torch.clamp(bidx, min=0).to(torch.int64)
    z_per_ray = z[b0]                                        # [R, z_dim]

    def sdf_fn_flat(x):
        n = x.shape[0] // r
        if per_instance_z:
            return model.implicit_surface.forward_sdf(
                x, z, torch.repeat_interleave(b0, n))["sdf"]
        return model.implicit_surface.forward_sdf(
            x, torch.repeat_interleave(z_per_ray, n, 0))["sdf"]

    t, valid = _upsample_rounds(sdf_fn_flat, o_n, d_n, t, valid, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, draw)
    s = t.shape[1]
    x = (o_n[:, None, :] + d_n[:, None, :] * t[..., None]).reshape(r * s, 3)
    v = rays_d[:, None, :].expand(r, s, 3).reshape(r * s, 3)
    if per_instance_z:
        out = model(x, v, z, torch.repeat_interleave(b0, s),
                    with_rgb=with_rgb)
    else:
        out = model(x, v, torch.repeat_interleave(z_per_ray, s, 0),
                    with_rgb=with_rgb)
    return _batched_composite(out, t, valid, ray_mask, bidx,
                              model.forward_inv_s(), with_rgb)


def neus_ray_query_batched_dynamic(model, space, ray_tested: Dict,
                                   z: torch.Tensor, bidx: torch.Tensor,
                                   ts: torch.Tensor, *, n_coarse: int = 64,
                                   upsample_inv_s_factors: Sequence[float] = (
                                       1.0, 4.0),
                                   n_importance: int = 16,
                                   upsample_inv_s: float = 64.0,
                                   with_rgb: bool = True,
                                   draw: Optional[Draw] = None
                                   ) -> Tuple[Dict, Dict]:
    """Latent- and time-conditioned batched query: z [B, z_dim], bidx [R]
    each ray's instance, ts [R] each ray's timestamp; the field is called
    as (x, v, z_rep, ts_rep). ``draw`` as in `neus_ray_query_batched`."""
    rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
    near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
        ray_tested["mask"]
    o_n, d_n = _normalize_batched(space, rays_o, rays_d, bidx)
    r = rays_o.shape[0]
    u = None if draw is None else draw((r, n_coarse), 0.0, 1.0)
    t, _ = batch_sample_step_linear(near, far, n_coarse, u)
    valid = torch.ones_like(t, dtype=torch.bool)
    z_per_ray = z[torch.clamp(bidx, min=0).to(torch.int64)]

    def sdf_fn_flat(x):
        n = x.shape[0] // r
        return model.implicit_surface.forward_sdf(
            x, torch.repeat_interleave(z_per_ray, n, 0),
            torch.repeat_interleave(ts, n))["sdf"]

    t, valid = _upsample_rounds(sdf_fn_flat, o_n, d_n, t, valid, far,
                                upsample_inv_s, upsample_inv_s_factors,
                                n_importance, draw)
    s = t.shape[1]
    x = (o_n[:, None, :] + d_n[:, None, :] * t[..., None]).reshape(r * s, 3)
    v = rays_d[:, None, :].expand(r, s, 3).reshape(r * s, 3)
    out = model(x, v, torch.repeat_interleave(z_per_ray, s, 0),
                torch.repeat_interleave(ts, s), with_rgb=with_rgb)
    return _batched_composite(out, t, valid, ray_mask, bidx,
                              model.forward_inv_s(), with_rgb)
