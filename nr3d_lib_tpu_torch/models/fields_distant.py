"""Distant-background fields, NeRF++'s inverted sphere (port of
nr3d_lib_tpu/models/fields_distant.py `NeRFDistant`,
`nerf_distant_ray_query`, `ray_sphere_exit_t`, `NeRFDistantModel`,
`composite_inner_distant`): points beyond the scene sphere are
parameterized as (x̂, 1/r) and sampled on shells uniform in inverse radius
(or in log radius).

Randomness: the perturbed samplers take their uniforms as an argument (`u`
[R, S] for `nerf_distant_ray_query`, one [S] draw of the shell jitter for
the model), as the port's other queries do (`graphics.raysample.Draw`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.graphics.nerf import ray_alpha_to_vw, tau_to_alpha
from nr3d_lib_tpu_torch.graphics.raysample import Draw, uniform_draw
from nr3d_lib_tpu_torch.models.blocks import MLP
from nr3d_lib_tpu_torch.models.embedders import get_embedder
from nr3d_lib_tpu_torch.models.fields.nerf import RadianceNet, trunc_exp
from nr3d_lib_tpu_torch.models.model_base import ModelMixin

__all__ = ["NeRFDistant", "nerf_distant_ray_query", "NeRFDistantModel",
           "composite_inner_distant", "ray_sphere_exit_t",
           "inverted_sphere_coords"]


def inverted_sphere_coords(x: torch.Tensor, radius: float = 1.0
                           ) -> torch.Tensor:
    """World point outside the sphere → the 4D NeRF++ coords (x̂, 1/r)."""
    r = torch.linalg.norm(x, dim=-1, keepdim=True) / radius
    return torch.cat([x / torch.clamp(r * radius, min=1e-8),
                      1.0 / torch.clamp(r, min=1.0)], -1)


class NeRFDistant(nn.Module):
    """Background NeRF over inverted-sphere coords: a density MLP over
    their sinusoidal embedding and a radiance net."""

    def __init__(self, *, pos_embed_cfg: Optional[dict] = None,
                 D: int = 3, W: int = 64, n_geo_feat: int = 15,
                 radiance_cfg: Optional[dict] = None,
                 radius: float = 1.0, seed: int = 0, device=None):
        super().__init__()
        self.radius = radius
        self.embed_fn, pos_dim = get_embedder(
            pos_embed_cfg or {"type": "sinusoidal", "n_frequencies": 4}, 4)
        self.sigma_mlp = MLP(pos_dim, 1 + n_geo_feat, D=D, W=W, seed=seed,
                             device=device)
        self.radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                    **(radiance_cfg or {}), seed=seed + 1,
                                    device=device)

    def forward_density(self, x_world: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        h = self.sigma_mlp(self.embed_fn(
            inverted_sphere_coords(x_world, self.radius)))
        return {"sigma": trunc_exp(h[..., 0]), "h": h[..., 1:]}

    def forward(self, x_world: torch.Tensor,
                v: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        out = self.forward_density(x_world)
        out["rgb"] = self.radiance(x_world, v, None, out["h"])
        return out


def _composite(model: NeRFDistant, rays_o, rays_d, t, dt, valid=None,
               with_rgb: bool = True):
    """Density (and radiance) at the [R, S] samples t, alpha from σ·dt,
    the volume composite."""
    r0, s = t.shape
    x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    flat = x.reshape(-1, 3)
    den = model.forward_density(flat)
    sigma = den["sigma"].reshape(r0, s)
    if valid is not None:
        sigma = torch.where(valid, sigma, torch.zeros_like(sigma))
    alpha = tau_to_alpha(sigma * dt)
    vw = ray_alpha_to_vw(alpha)
    acc = torch.sum(vw, -1)
    rendered = {"mask_volume": acc,
                "depth_volume": torch.sum(vw * t, -1)
                / torch.clamp(acc, min=1e-10)}
    if with_rgb:
        v = rays_d[:, None, :].expand(x.shape).reshape(-1, 3)
        rgb = model.radiance(flat, v, None, den["h"]).reshape(r0, s, 3)
        rendered["rgb_volume"] = torch.sum(vw[..., None] * rgb, -2)
    return rendered, alpha, vw


def nerf_distant_ray_query(model: NeRFDistant, rays_o: torch.Tensor,
                           rays_d: torch.Tensor, far_inner: torch.Tensor, *,
                           n_samples: int = 32,
                           u: Optional[torch.Tensor] = None
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      Dict[str, torch.Tensor]]:
    """Sample the background shell uniformly in inverse radius beyond the
    inner sphere's exit far_inner [R]: 1/s at the bin edges 1 … 1/n, or
    with `u` [R, n_samples] in [0,1) jittered inside each of n bins of
    (0, 1]; t = far_inner / (1/s)."""
    r0 = rays_o.shape[0]
    dev, dt_ = rays_o.device, rays_o.dtype
    if u is None:
        inv_s = torch.linspace(1.0, 1.0 / n_samples, n_samples, dtype=dt_,
                               device=dev).expand(r0, n_samples)
    else:
        edges = torch.linspace(1.0, 0.0, n_samples + 1, dtype=dt_,
                               device=dev)
        inv_s = edges[:-1] - u * (edges[:-1] - edges[1:])
    t = far_inner[:, None] / torch.clamp(inv_s, min=1e-3)      # growing
    dt = torch.cat([t[:, 1:] - t[:, :-1], 1e8 * torch.ones_like(t[:, :1])],
                   -1)
    rendered, alpha, vw = _composite(model, rays_o, rays_d, t, dt)
    return rendered, {"t": t, "alpha": alpha, "vw": vw}


def ray_sphere_exit_t(rays_o: torch.Tensor, rays_d: torch.Tensor, r
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The far intersection t of unit-direction rays with the sphere
    |x| = r (r a scalar, [R] or [R, S]) → (t, valid)."""
    b = torch.sum(rays_o * rays_d, -1)
    c = torch.sum(rays_o * rays_o, -1)
    r = torch.as_tensor(r, dtype=rays_o.dtype, device=rays_o.device)
    if r.dim() > 1:
        b, c = b[:, None], c[:, None]
    disc = b * b - (c - r ** 2)
    t = -b + torch.sqrt(torch.clamp(disc, min=0.0))
    return t, (disc > 0) & (t > 0)


class NeRFDistantModel(nn.Module, ModelMixin):
    """Renderable distant background: the samples lie on shells between
    radius_scale_min and radius_scale_max around the inner scene sphere.

    interval_type: 'inverse_proportional' (shells uniform in 1/r, NeRF++)
        or 'logarithm' (uniform in log r).
    sample_mode: 'spherical' (where the ray crosses each shell) or
        'lindisp' (t is the shell radius).

    `device=None` means CUDA (raises without a card); tests pass
    `device="cpu"`."""

    def __init__(self, *, field_cfg: Optional[dict] = None,
                 radius_scale_min: float = 1.0,
                 radius_scale_max: float = 1000.0,
                 include_inf_distance: bool = True,
                 interval_type: str = "inverse_proportional",
                 sample_mode: str = "spherical",
                 n_samples: int = 32, seed: int = 0, device=None):
        super().__init__()
        if interval_type not in ("inverse_proportional", "logarithm"):
            raise ValueError(f"unknown interval_type {interval_type!r}")
        if sample_mode not in ("spherical", "lindisp"):
            raise ValueError(f"unknown sample_mode {sample_mode!r}")
        self.device = resolve_device(device)
        self.field = NeRFDistant(**(field_cfg or {}), seed=seed,
                                 device=self.device)
        self.radius_scale_min = float(radius_scale_min)
        self.radius_scale_max = float(radius_scale_max)
        self.include_inf_distance = bool(include_inf_distance)
        self.interval_type = interval_type
        self.sample_mode = sample_mode
        self.n_samples = int(n_samples)
        self.space = None          # unbounded: ray_test passes every ray

    def ray_test(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 near=None, far=None) -> Dict[str, torch.Tensor]:
        """Every ray: near is where it leaves the inner sphere
        (radius_scale_min), far is infinite."""
        t_exit, _ = ray_sphere_exit_t(rays_o, rays_d, self.radius_scale_min)
        r = rays_o.shape[0]
        return {"rays_o": rays_o, "rays_d": rays_d, "near": t_exit,
                "far": torch.full((r,), float("inf"), dtype=rays_o.dtype,
                                  device=rays_o.device),
                "mask": torch.ones((r,), dtype=torch.bool,
                                   device=rays_o.device), "num_rays": r}

    def _shell_radii(self, n: int, u: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """[n] ascending shell radii; `u` [n] in [0,1) jitters them."""
        i = torch.arange(n, dtype=torch.float32, device=self.device)
        if self.interval_type == "inverse_proportional":
            hi, lo = 1.0 / self.radius_scale_min, 1.0 / self.radius_scale_max
            step = (hi - lo) / n
            r_reci = hi - i * step
            if u is not None:
                r_reci = torch.clamp(r_reci - u * step, min=1e-5)
            return 1.0 / r_reci
        lo, hi = math.log10(self.radius_scale_min), \
            math.log10(self.radius_scale_max)
        step = (hi - lo) / n
        r_log = lo + i * step
        if u is not None:
            r_log = r_log + u * step
        return torch.pow(10.0, r_log)

    def ray_query(self, ray_tested: Dict,
                  generator: Optional[torch.Generator] = None,
                  with_rgb: bool = True, draw: Optional[Draw] = None
                  ) -> Tuple[Dict, Dict]:
        """Render the background. A `generator` (or a `draw` callable,
        which takes precedence) jitters the shells, one [n_samples] draw
        in [0,1) shared by every ray (JAX's `key`)."""
        rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
        r0, s = rays_o.shape[0], self.n_samples
        if draw is None and generator is not None:
            draw = uniform_draw(generator)
        u = None if draw is None else draw((s,), 0.0, 1.0)
        radii = self._shell_radii(s, u)
        if self.sample_mode == "spherical":
            t, valid = ray_sphere_exit_t(rays_o, rays_d,
                                         radii.expand(r0, s))
        else:          # lindisp: t is the shell radius
            t = radii.expand(r0, s)
            valid = torch.ones_like(t, dtype=torch.bool)
        t = torch.maximum(t, ray_tested["near"][:, None])
        dt_last = 1e8 if self.include_inf_distance else self.radius_scale_max
        dt = torch.cat([t[:, 1:] - t[:, :-1],
                        torch.full_like(t[:, :1], dt_last)], -1)
        rendered, alpha, vw = _composite(
            self.field, rays_o, rays_d, t, torch.clamp(dt, min=0.0), valid,
            with_rgb)
        return rendered, {"t": t, "alpha": alpha, "vw": vw,
                          "ray_mask": ray_tested["mask"]}


def composite_inner_distant(rendered_inner: Dict[str, torch.Tensor],
                            rendered_distant: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """A distant background behind a close-range render: the background
    sees only the transmittance the foreground leaves over."""
    acc_fg = rendered_inner["mask_volume"]
    leftover = (1.0 - acc_fg)[..., None]
    out = dict(rendered_inner)
    if "rgb_volume" in rendered_inner and "rgb_volume" in rendered_distant:
        out["rgb_volume"] = (rendered_inner["rgb_volume"]
                             + leftover * rendered_distant["rgb_volume"])
    out["mask_volume"] = acc_fg + (1.0 - acc_fg) * \
        rendered_distant["mask_volume"]
    return out
