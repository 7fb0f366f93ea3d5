"""Renderable models of the dynamic, conditional and conditional-dynamic
field families (port of nr3d_lib_tpu/models/model_families.py
`DynamicPermutoNeuSModel`, `GenerativePermutoNeuSModelBatched`,
`StyleLoTDNeuSModelBatched`, `DynamicGenerativeNeuSModel`,
`EmerNeRFModel`). Each owns its field, space, accel and (the batched
ones) the autodecoder latents, and implements the `ModelMixin` lifecycle.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.graphics.raysample import Draw, uniform_draw
from nr3d_lib_tpu_torch.models.accelerations import (
    OccGridAccelDynamic, OccGridAccelStaticAndDynamic)
from nr3d_lib_tpu_torch.models.autodecoder import AutoDecoderMixin
from nr3d_lib_tpu_torch.models.model_base import ModelMixin, _query
from nr3d_lib_tpu_torch.models.spatial import AABBDynamicSpace, AABBSpace

__all__ = ["DynamicPermutoNeuSModel", "GenerativePermutoNeuSModelBatched",
           "StyleLoTDNeuSModelBatched", "DynamicGenerativeNeuSModel",
           "EmerNeRFModel"]


class DynamicPermutoNeuSModel(nn.Module, ModelMixin):
    """Time-conditioned NeuS: a (x,t) permutohedral NeuS field, an AABB
    space with a time span, one occupancy grid per time key. The rays of
    `ray_query` carry their timestamps as `ray_tested["ts"]` [R] in
    [-1, 1]. `device=None` means CUDA (raises without a card); tests pass
    `device="cpu"`."""

    def __init__(self, *, field_cfg: Optional[dict] = None,
                 space_cfg: Optional[dict] = None,
                 accel_cfg: Optional[dict] = None,
                 ray_query_cfg: Optional[dict] = None,
                 n_time_keys: int = 8, seed: int = 0, device=None):
        super().__init__()
        from nr3d_lib_tpu_torch.models.fields_dynamic import \
            DynamicPermutoConcatNeuS

        self.device = resolve_device(device)
        self.field = DynamicPermutoConcatNeuS(**(field_cfg or {}), seed=seed,
                                              device=self.device)
        self.space = AABBDynamicSpace(**(space_cfg or {}), device=self.device)
        self.accel = OccGridAccelDynamic(n_time_keys, **(accel_cfg or {}),
                                         device=self.device)
        self.ray_query_cfg = dict(ray_query_cfg or {})

    @property
    def implicit_surface(self):
        return self.field.implicit_surface

    def forward_inv_s(self) -> torch.Tensor:
        return self.field.forward_inv_s()

    def forward(self, x, v, ts, with_rgb: bool = True):
        return self.field(x, v, ts, with_rgb=with_rgb)

    def query_occ_val(self, x: torch.Tensor, key_idx: torch.Tensor
                      ) -> torch.Tensor:
        """Occupancy value at the time key key_idx:
        sigmoid(−|sdf|·inv_s)·4."""
        ts = self.accel.ts_keyframes[key_idx]
        sdf = self.field.implicit_surface.forward_sdf(x, ts)["sdf"]
        inv_s = self.field.forward_inv_s().detach()
        return torch.sigmoid(-torch.abs(sdf) * inv_s) * 4.0

    def _accel_query(self, x_batched: torch.Tensor, bidx: torch.Tensor
                     ) -> torch.Tensor:
        b, n, _ = x_batched.shape
        return self.query_occ_val(x_batched.reshape(b * n, 3),
                                  bidx.reshape(b * n)).reshape(b, n)

    @torch.no_grad()
    def populate(self, generator: Optional[torch.Generator] = None):
        """One EMA update of every time key's grid from the field. No
        generator → one seeded with 0 (JAX: `jax.random.key(0)`)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.accel.occ.step_update(generator, self._accel_query)

    def training_before_per_step(self, it: int,
                                 generator: Optional[torch.Generator] = None):
        """Per-step schedules, then the occupancy EMA update (every
        `lifecycle_update_every` steps). No generator → one seeded by
        `it`."""
        self.field.var_ctrl.set_iter(it)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(it)
        with torch.no_grad():
            self.accel.step(it, generator, self._accel_query)

    def ray_query(self, ray_tested: Dict,
                  generator: Optional[torch.Generator] = None,
                  with_rgb: bool = True, draw: Optional[Draw] = None
                  ) -> Tuple[Dict, Dict]:
        """Render the tested rays at their `ts`, in the span `query`. A
        `generator` (or a `draw` callable, which takes precedence)
        perturbs the samples, as for training; neither renders
        unperturbed."""
        from nr3d_lib_tpu_torch.graphics.neus_ray_query_variants import \
            neus_ray_query_dynamic

        cfg = dict(self.ray_query_cfg)
        cfg.pop("query_mode", None)
        if draw is None and generator is not None:
            draw = uniform_draw(generator)
        return _query(neus_ray_query_dynamic, self, self.space, ray_tested,
                      ray_tested["ts"], with_rgb=with_rgb, draw=draw, **cfg)


class _BatchedNeuSModelBase(nn.Module, ModelMixin):
    """Latent-conditioned batched NeuS: the autodecoder latents, one shared
    AABB space and the batched query. The rays of `ray_query` carry their
    instance as `ray_tested["bidx"]` [R] (bidx < 0 renders empty)."""

    def __init__(self, n_instances: int, latent_dim: int, *,
                 space_cfg: Optional[dict] = None,
                 ray_query_cfg: Optional[dict] = None,
                 latent_std: float = 0.01, seed: int = 0, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.autodecoder = AutoDecoderMixin(n_instances, latent_dim,
                                            latent_std=latent_std,
                                            seed=seed + 100,
                                            device=self.device)
        self.space = AABBSpace(**(space_cfg or {}), device=self.device)
        self.ray_query_cfg = dict(ray_query_cfg or {})
        self.n_instances = n_instances

    @property
    def implicit_surface(self):
        return self.field.implicit_surface

    def forward_inv_s(self) -> torch.Tensor:
        return self.field.forward_inv_s()

    def forward(self, x, v, z, with_rgb: bool = True):
        return self.field(x, v, z, with_rgb=with_rgb)

    def _latents(self) -> torch.Tensor:
        return self.autodecoder.get_latent(
            torch.arange(self.n_instances, device=self.device))

    def _query(self, ray_tested: Dict, generator, with_rgb: bool, draw,
               **extra) -> Tuple[Dict, Dict]:
        from nr3d_lib_tpu_torch.graphics.neus_ray_query_variants import \
            neus_ray_query_batched

        cfg = dict(self.ray_query_cfg)
        cfg.pop("query_mode", None)
        if draw is None and generator is not None:
            draw = uniform_draw(generator)
        return neus_ray_query_batched(self, self.space, ray_tested,
                                      self._latents(), ray_tested["bidx"],
                                      with_rgb=with_rgb, draw=draw, **extra,
                                      **cfg)

    def ray_query(self, ray_tested: Dict,
                  generator: Optional[torch.Generator] = None,
                  with_rgb: bool = True, draw: Optional[Draw] = None
                  ) -> Tuple[Dict, Dict]:
        """Render each tested ray's instance. A `generator` (or a `draw`
        callable, which takes precedence) perturbs the samples, as for
        training; neither renders unperturbed."""
        return self._query(ray_tested, generator, with_rgb, draw)

    def training_before_per_step(self, it: int,
                                 generator: Optional[torch.Generator] = None):
        self.field.var_ctrl.set_iter(it)


class GenerativePermutoNeuSModelBatched(_BatchedNeuSModelBase):
    """Batched generative-permuto NeuS: one field over [x, z] for a
    category of instances. `device=None` means CUDA."""

    def __init__(self, n_instances: int, latent_dim: int = 4, *,
                 field_cfg: Optional[dict] = None, **kw):
        from nr3d_lib_tpu_torch.models.fields_conditional import \
            GenerativePermutoConcatNeuS

        super().__init__(n_instances, latent_dim, **kw)
        self.field = GenerativePermutoConcatNeuS(
            latent_dim, **(field_cfg or {}), seed=kw.get("seed", 0),
            device=self.device)


class StyleLoTDNeuSModelBatched(_BatchedNeuSModelBase):
    """Batched style-LoTD NeuS: a grower makes each instance's LoTD
    parameters from its latent. `device=None` means CUDA."""

    def __init__(self, n_instances: int, latent_dim: int = 8, *,
                 field_cfg: Optional[dict] = None, **kw):
        from nr3d_lib_tpu_torch.models.fields_conditional import \
            StyleLoTDNeuS

        super().__init__(n_instances, latent_dim, **kw)
        self.field = StyleLoTDNeuS(z_dim=latent_dim, **(field_cfg or {}),
                                   seed=kw.get("seed", 0), device=self.device)

    def forward(self, x, v, z, bidx=None, with_rgb: bool = True):
        return self.field(x, v, z, bidx, with_rgb=with_rgb)

    def ray_query(self, ray_tested: Dict,
                  generator: Optional[torch.Generator] = None,
                  with_rgb: bool = True, draw: Optional[Draw] = None
                  ) -> Tuple[Dict, Dict]:
        """As the base class's, with the field called on the instance
        table and each point's bidx (`per_instance_z`)."""
        return self._query(ray_tested, generator, with_rgb, draw,
                           per_instance_z=True)


class DynamicGenerativeNeuSModel(_BatchedNeuSModelBase):
    """Conditional + dynamic NeuS: one field over [x, z, t]. The rays
    carry `bidx` and `ts` [R] in [-1, 1]. `device=None` means CUDA."""

    def __init__(self, n_instances: int, latent_dim: int = 4, *,
                 field_cfg: Optional[dict] = None, **kw):
        from nr3d_lib_tpu_torch.models.fields_conditional_dynamic import \
            DynamicGenerativePermutoConcatNeuS

        super().__init__(n_instances, latent_dim, **kw)
        self.field = DynamicGenerativePermutoConcatNeuS(
            latent_dim, **(field_cfg or {}), seed=kw.get("seed", 0),
            device=self.device)

    def forward(self, x, v, z, ts, with_rgb: bool = True):
        return self.field(x, v, z, ts, with_rgb=with_rgb)

    def ray_query(self, ray_tested: Dict,
                  generator: Optional[torch.Generator] = None,
                  with_rgb: bool = True, draw: Optional[Draw] = None
                  ) -> Tuple[Dict, Dict]:
        from nr3d_lib_tpu_torch.graphics.neus_ray_query_variants import \
            neus_ray_query_batched_dynamic

        cfg = dict(self.ray_query_cfg)
        cfg.pop("query_mode", None)
        if draw is None and generator is not None:
            draw = uniform_draw(generator)
        return neus_ray_query_batched_dynamic(
            self, self.space, ray_tested, self._latents(),
            ray_tested["bidx"], ray_tested["ts"], with_rgb=with_rgb,
            draw=draw, **cfg)


_BRANCH_KEYS = {"full": ("sigma", "rgb"),
                "static": ("sigma_static", "rgb_static"),
                "dynamic": ("sigma_dynamic", "rgb_dynamic")}


class EmerNeRFModel(nn.Module, ModelMixin):
    """Renderable EmerNeRF: the static + dynamic decomposition, flow-based
    temporal aggregation, a static grid beside the time-keyed dynamic
    grids, and the per-step regularizers in the volume buffer
    (`reg_dynamic_sparsity`, `reg_flow_smooth`, `reg_flow_cycle`,
    `reg_shadow`). The rays carry `ts` [R] in [-1, 1]. `device=None`
    means CUDA (raises without a card); tests pass `device="cpu"`.

    The render marches `n_march_steps` steps of 2/n_march_steps and keeps
    the candidates that the static grid or the any-time union of the
    dynamic grids marks occupied: two occupancy lookups a render (B5 on
    the card)."""

    def __init__(self, *, field_cfg: Optional[dict] = None,
                 space_cfg: Optional[dict] = None,
                 accel_cfg: Optional[dict] = None,
                 n_time_keys: int = 8,
                 temporal_aggregation: bool = True,
                 temporal_delta: float = 0.05,
                 n_march_steps: int = 96,
                 only_dynamic: bool = False,
                 ray_query_cfg: Optional[dict] = None, seed: int = 0,
                 device=None):
        super().__init__()
        from nr3d_lib_tpu_torch.models.fields_dynamic import (
            EmerNeRF, EmerNeRFOnlyDynamic)

        self.device = resolve_device(device)
        cls = EmerNeRFOnlyDynamic if only_dynamic else EmerNeRF
        self.field = cls(**(field_cfg or {}), seed=seed, device=self.device)
        self.space = AABBDynamicSpace(**(space_cfg or {}),
                                      device=self.device)
        self.accel = OccGridAccelStaticAndDynamic(
            n_time_keys, **(accel_cfg or {"resolution": (32, 32, 32)}),
            device=self.device)
        self.temporal_aggregation = bool(temporal_aggregation)
        self.temporal_delta = float(temporal_delta)
        self.n_march_steps = int(n_march_steps)
        self.ray_query_cfg = dict(ray_query_cfg or {})

    def query_sigma(self, x: torch.Tensor, ts) -> torch.Tensor:
        return self.field(x, None, ts, with_rgb=False)["sigma"]

    def sample_pts_uniform(self, generator: torch.Generator,
                           num_samples: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform (x [n, 3], ts [n]) in the normalized volume, on the
        model's device."""
        dev = generator.device
        x = torch.rand((num_samples, 3), generator=generator,
                       device=dev) * 2.0 - 1.0
        ts = torch.rand((num_samples,), generator=generator,
                        device=dev) * 2.0 - 1.0
        return x.to(self.device), ts.to(self.device)

    def _any_occ(self, x: torch.Tensor) -> torch.Tensor:
        """Static ∪ any-time dynamic occupancy at x [n, 3]: two lookups."""
        from nr3d_lib_tpu_torch.ops.occgrid_march import occgrid_query

        return occgrid_query(self.accel.static.occ(), x) | occgrid_query(
            torch.any(self.accel.dynamic.occ.occ(), 0), x)

    def sample_pts_in_occupied(self, generator: torch.Generator,
                               num_samples: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x, ts) biased to occupied cells: 4n uniform candidates, then n
        drawn with replacement with weight 1 + 1e-6 in an occupied cell and
        1e-6 elsewhere (uniform when the grids are empty)."""
        x, ts = self.sample_pts_uniform(generator, 4 * num_samples)
        p = self._any_occ(x).to(torch.float32) + 1e-6
        idx = torch.multinomial((p / torch.sum(p)).to(generator.device),
                                num_samples, replacement=True,
                                generator=generator).to(self.device)
        return x[idx], ts[idx]

    def _static_query(self, x: torch.Tensor) -> torch.Tensor:
        """σ_static at x [n, 3] (t = 0), the static grid's values."""
        return self.field(x, None, torch.zeros(x.shape[0], device=x.device),
                          with_rgb=False)["sigma_static"]

    def _dyn_query(self, xb: torch.Tensor, bidx: torch.Tensor
                   ) -> torch.Tensor:
        """σ_dynamic of the dynamic grids' update points xb [T, n, 3] at
        their grids' keyframe times."""
        b, n, _ = xb.shape
        ts = self.accel.dynamic.ts_keyframes[bidx.reshape(-1)]
        out = self.field(xb.reshape(b * n, 3), None, ts, with_rgb=False)
        return out["sigma_dynamic"].reshape(b, n)

    @torch.no_grad()
    def populate(self, generator: Optional[torch.Generator] = None):
        """The static grid from σ_static at its cell centers (t = 0), then
        one EMA update of every dynamic grid. No generator → one seeded
        with 0 (JAX: `jax.random.key(0)`)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.accel.static.init_from_net(self._static_query)
        self.accel.dynamic.occ.step_update(generator, self._dyn_query)

    def training_before_per_step(self, it: int,
                                 generator: Optional[torch.Generator] = None):
        """Every `accel.dynamic.update_every` steps, the EMA update of the
        dynamic grids (the static grid keeps its populate values, as in
        JAX). No generator → one seeded by `it`."""
        if it % self.accel.dynamic.update_every != 0:
            return
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(it)
        with torch.no_grad():
            self.accel.dynamic.occ.step_update(generator, self._dyn_query)

    def _field_with_temporal_agg(self, x: torch.Tensor,
                                 v: Optional[torch.Tensor], ts,
                                 with_rgb: bool) -> Dict:
        """The field's outputs with flow-based temporal aggregation. A
        field that aggregates itself (EmerNeRF's default) blends the
        flow-warped (t−dt, t, t+dt) features inside; its cycle residuals
        become `flow_cycle`. Otherwise, with the model's
        `temporal_aggregation` and a flow head, the dynamic branch is
        averaged over the field at the points warped to t ± Δ."""
        out = self.field(x, v, ts, with_rgb=with_rgb)
        if getattr(self.field, "temporal_aggregation", False):
            if "flow_fwd_pred_bwd" in out:
                out["flow_cycle"] = torch.cat(
                    [out["flow_fwd"] + out["flow_fwd_pred_bwd"],
                     out["flow_bwd"] + out["flow_bwd_pred_fwd"]], -1)
            return out
        if not (self.temporal_aggregation and self.field.use_flow):
            return out
        dt = self.temporal_delta
        out_fwd = self.field(x + out["flow_fwd"] * dt, v, ts + dt,
                             with_rgb=with_rgb)
        out_bwd = self.field(x - out["flow_bwd"] * dt, v, ts - dt,
                             with_rgb=with_rgb)
        out["sigma_dynamic"] = (out["sigma_dynamic"]
                                + out_fwd["sigma_dynamic"]
                                + out_bwd["sigma_dynamic"]) / 3.0
        out["sigma"] = out["sigma_static"] + out["sigma_dynamic"]
        if with_rgb:
            rgb_d = (out["rgb_dynamic"] + out_fwd["rgb_dynamic"]
                     + out_bwd["rgb_dynamic"]) / 3.0
            ratio = (out["sigma_dynamic"]
                     / torch.clamp(out["sigma"], min=1e-8))[..., None]
            out["rgb"] = out["rgb_static"] * (1 - ratio) + rgb_d * ratio
            out["rgb_dynamic"] = rgb_d
        out["flow_cycle"] = out_fwd["flow_bwd"] - out["flow_fwd"]
        return out

    def ray_query(self, ray_tested: Dict,
                  generator: Optional[torch.Generator] = None,
                  with_rgb: bool = True, draw: Optional[Draw] = None,
                  branch: str = "full") -> Tuple[Dict, Dict]:
        """Render the tested rays at their `ts`. `branch` "static" or
        "dynamic" composites that branch's density and colour alone. A
        `generator` (or a `draw` callable, which takes precedence)
        jitters the march, one [R, n_march_steps] draw in [0,1) (JAX's
        `perturb_key`); neither renders at the step midpoints."""
        from nr3d_lib_tpu_torch.graphics.nerf import (ray_alpha_to_vw,
                                                      tau_to_alpha)
        from nr3d_lib_tpu_torch.ops.occgrid_march import march_steps

        sigma_key, rgb_key = _BRANCH_KEYS[branch]
        rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
        near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
            ray_tested["mask"]
        ts = ray_tested["ts"]
        o_n, d_n = self.space.normalize_rays(rays_o, rays_d)
        if draw is None and generator is not None:
            draw = uniform_draw(generator)
        r, s = rays_o.shape[0], self.n_march_steps
        u = None if draw is None else draw((r, s), 0.0, 1.0)
        t, dt_steps, in_range = march_steps(near, far, s, 2.0 / s, u=u)
        flat_x = (o_n[:, None, :] + d_n[:, None, :] * t[..., None]
                  ).reshape(r * s, 3)
        smask = in_range & self._any_occ(flat_x).reshape(r, s)

        ts_rep = torch.repeat_interleave(ts, s)
        v = rays_d[:, None, :].expand(r, s, 3).reshape(r * s, 3)
        out = self._field_with_temporal_agg(flat_x, v, ts_rep, with_rgb)
        zero = torch.zeros_like(t)
        sigma = torch.where(smask, out[sigma_key].reshape(r, s), zero)
        alpha = tau_to_alpha(sigma * dt_steps)
        alpha = torch.where(ray_mask[:, None], alpha, zero)
        vw = ray_alpha_to_vw(alpha)
        acc = torch.sum(vw, -1)
        zero_r = torch.zeros_like(acc)
        depth = torch.sum(vw * t, -1) / torch.clamp(acc, min=1e-10)
        rendered = {"mask_volume": torch.where(ray_mask, acc, zero_r),
                    "depth_volume": torch.where(ray_mask, depth, zero_r)}
        if with_rgb:
            for k, key in (("rgb_volume", rgb_key),
                           ("rgb_static_volume", "rgb_static"),
                           ("rgb_dynamic_volume", "rgb_dynamic")):
                c = torch.sum(vw[..., None] * out[key].reshape(r, s, 3), -2)
                rendered[k] = torch.where(ray_mask[:, None], c,
                                          torch.zeros_like(c))
        sigma_d = out["sigma_dynamic"].reshape(r, s)
        vb = {"t": t, "alpha": alpha, "vw": vw, "ray_mask": ray_mask,
              "sigma_static": out["sigma_static"].reshape(r, s),
              "sigma_dynamic": sigma_d,
              "reg_dynamic_sparsity": torch.mean(
                  torch.where(smask, sigma_d, zero))}
        if self.field.use_flow:
            vb["reg_flow_smooth"] = torch.mean(out["flow_fwd"] ** 2
                                               + out["flow_bwd"] ** 2)
            if "flow_cycle" in out:
                vb["reg_flow_cycle"] = torch.mean(out["flow_cycle"] ** 2)
        if self.field.use_shadow and with_rgb:
            vb["reg_shadow"] = torch.mean(out["shadow"] ** 2)
        return rendered, vb

    def ray_query_static(self, ray_tested: Dict,
                         generator: Optional[torch.Generator] = None,
                         with_rgb: bool = True, draw: Optional[Draw] = None
                         ) -> Tuple[Dict, Dict]:
        """The static branch alone."""
        return self.ray_query(ray_tested, generator, with_rgb, draw,
                              branch="static")

    def ray_query_dynamic(self, ray_tested: Dict,
                          generator: Optional[torch.Generator] = None,
                          with_rgb: bool = True, draw: Optional[Draw] = None
                          ) -> Tuple[Dict, Dict]:
        """The dynamic branch alone."""
        return self.ray_query(ray_tested, generator, with_rgb, draw,
                              branch="dynamic")
