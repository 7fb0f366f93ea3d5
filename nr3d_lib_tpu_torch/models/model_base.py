"""ModelMixin lifecycle API + the LoTD NeuS and NeRF models (port of
nr3d_lib_tpu/models/model_base.py `ModelMixin`, `LoTDNeuSModel`,
`LoTDNeRFModel`).

A renderable model owns (field net, space, accel) and dispatches
`ray_query` to the strategy function of its query mode. Ported modes: the
NeuS `march_occ_multi_upsample_compressed` and `coarse_multi_upsample`,
the NeRF `march_occ` and `march_occ_compressed`; the others raise (the
NeRF's fixed query is a plain function, `graphics.nerf_ray_query.
nerf_ray_query_fixed`, as in JAX).

Randomness: `jax.random` keys become a `torch.Generator` (`ray_query`'s
`generator`, `training_before_per_step`'s), or a `draw` callable through
which a caller hands the query its uniforms (`graphics.raysample`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.graphics.raysample import Draw, uniform_draw
from nr3d_lib_tpu_torch.models.accelerations import OccGridAccel
from nr3d_lib_tpu_torch.models.spatial import AABBSpace

__all__ = ["ModelMixin", "LoTDNeuSModel", "LoTDNeRFModel"]


class ModelMixin:
    """Lifecycle protocol: populate → ray_test → ray_query. The model
    provides `space` (and `accel`) as submodules."""

    def populate(self, **kwargs):
        pass

    def training_before_per_step(self, it: int,
                                 generator: Optional[torch.Generator] = None):
        pass

    def training_after_per_step(self, it: int,
                                generator: Optional[torch.Generator] = None):
        pass

    @property
    def lifecycle_update_every(self) -> int:
        """The interval at which the expensive lifecycle work (the
        occupancy EMA update) does anything: the accel's own update
        interval. A trainer that gates `training_before_per_step` to an
        interval derives it from here."""
        return int(getattr(getattr(self, "accel", None), "update_every", 1)
                   or 1)

    def has_stepwise_schedules(self) -> bool:
        """True if any submodule carries a schedule that advances every
        iteration (an `annealer`). A trainer that gates
        `training_before_per_step` to `lifecycle_update_every` would
        coarsen such a schedule into jumps, so it runs the hook every step
        then (the occupancy update stays gated: `accel.step` does nothing
        off its interval)."""
        mods = self.modules() if isinstance(self, nn.Module) else [self]
        return any(getattr(m, "annealer", None) is not None for m in mods)

    def ray_test(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 near=None, far=None) -> Dict:
        return self.space.ray_test(rays_o, rays_d, near=near, far=far)

    def ray_query(self, ray_tested: Dict,
                  generator: Optional[torch.Generator] = None,
                  with_rgb: bool = True, draw: Optional[Draw] = None
                  ) -> Tuple[Dict, Dict]:
        raise NotImplementedError


class LoTDNeuSModel(nn.Module, ModelMixin):
    """LoTD NeuS + AABB space + occ-grid accel + marched, upsampled,
    compressed ray query. `device=None` means CUDA (raises without a
    card); tests pass `device="cpu"`."""

    def __init__(self, *, field_cfg: Optional[dict] = None,
                 space_cfg: Optional[dict] = None,
                 accel_cfg: Optional[dict] = None,
                 ray_query_cfg: Optional[dict] = None, seed: int = 0,
                 device=None):
        super().__init__()
        from nr3d_lib_tpu_torch.models.fields.neus import LoTDNeuS

        self.device = resolve_device(device)
        self.field = LoTDNeuS(**(field_cfg or {}), seed=seed,
                              device=self.device)
        self.space = AABBSpace(**(space_cfg or {}), device=self.device)
        self.accel = OccGridAccel(**(accel_cfg or {}), device=self.device)
        self.ray_query_cfg = dict(ray_query_cfg or {})

    def forward_sdf(self, x: torch.Tensor):
        return self.field.forward_sdf(x)

    def forward_sdf_nablas(self, x: torch.Tensor):
        return self.field.forward_sdf_nablas(x)

    def forward_inv_s(self):
        return self.field.forward_inv_s()

    def forward(self, x, v=None, with_rgb=True, with_nablas=True):
        return self.field(x, v, with_rgb=with_rgb, with_nablas=with_nablas)

    def query_occ_val(self, x: torch.Tensor) -> torch.Tensor:
        """Occ-grid value query: sigmoid(−|sdf|·inv_s)·4."""
        sdf = self.field.forward_sdf(x)["sdf"]
        inv_s = self.field.forward_inv_s().detach()
        return torch.sigmoid(-torch.abs(sdf) * inv_s) * 4.0

    @torch.no_grad()
    def populate(self):
        """Initialize the occupancy values from the field."""
        self.accel.init(self.query_occ_val)

    def training_before_per_step(self, it: int,
                                 generator: Optional[torch.Generator] = None):
        """Per-step schedules, then the occupancy EMA update (every
        `lifecycle_update_every` steps). No generator → one seeded by `it`
        (JAX: `jax.random.key(it)`)."""
        self.field.implicit_surface.encoding.set_anneal_iter(it)
        self.field.var_ctrl.set_iter(it)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(it)
        with torch.no_grad():
            self.accel.step(it, generator, self.query_occ_val)

    def ray_query(self, ray_tested: Dict,
                  generator: Optional[torch.Generator] = None,
                  with_rgb: bool = True, draw: Optional[Draw] = None
                  ) -> Tuple[Dict, Dict]:
        """Render the tested rays. A `generator` (or a `draw` callable,
        which takes precedence) perturbs the samples, as for training;
        neither renders unperturbed."""
        cfg = dict(self.ray_query_cfg)
        mode = cfg.pop("query_mode", "march_occ_multi_upsample")
        if draw is None and generator is not None:
            draw = uniform_draw(generator)
        if mode == "march_occ_multi_upsample_compressed":
            from nr3d_lib_tpu_torch.graphics.neus_ray_query_variants import (
                neus_ray_query_march_occ_multi_upsample_compressed)

            return neus_ray_query_march_occ_multi_upsample_compressed(
                self, self.accel, self.space, ray_tested, with_rgb=with_rgb,
                draw=draw, **cfg)
        if mode == "coarse_multi_upsample":
            from nr3d_lib_tpu_torch.graphics.neus_ray_query import (
                neus_ray_query_coarse_multi_upsample)

            return neus_ray_query_coarse_multi_upsample(
                self, self.space, ray_tested, with_rgb=with_rgb, draw=draw,
                **cfg)
        raise NotImplementedError(
            f"query_mode {mode!r} is not ported yet (ROADMAP.md A8b)")


class LoTDNeRFModel(nn.Module, ModelMixin):
    """LoTD NeRF + AABB space + occ-grid accel + marched ray query.
    `device=None` means CUDA (raises without a card); tests pass
    `device="cpu"`."""

    def __init__(self, *, field_cfg: Optional[dict] = None,
                 space_cfg: Optional[dict] = None,
                 accel_cfg: Optional[dict] = None,
                 ray_query_cfg: Optional[dict] = None, seed: int = 0,
                 device=None):
        super().__init__()
        from nr3d_lib_tpu_torch.models.fields.nerf import LoTDNeRF

        self.device = resolve_device(device)
        self.field = LoTDNeRF(**(field_cfg or {}), seed=seed,
                              device=self.device)
        self.space = AABBSpace(**(space_cfg or {}), device=self.device)
        self.accel = OccGridAccel(**(accel_cfg or {}), device=self.device)
        self.ray_query_cfg = dict(ray_query_cfg or {})

    def forward_density(self, x: torch.Tensor):
        return self.field.forward_density(x)

    def radiance(self, x, v, n, h):
        return self.field.radiance(x, v, n, h)

    def query_density(self, x: torch.Tensor) -> torch.Tensor:
        return self.field.forward_density(x)["sigma"]

    @torch.no_grad()
    def populate(self):
        """The occupancy grid keeps its initial value (all occupied): the
        JAX model's `accel.init(key, None)`."""
        self.accel.init(None)

    def training_before_per_step(self, it: int,
                                 generator: Optional[torch.Generator] = None):
        """Per-step schedules, then the occupancy EMA update from the
        density (every `lifecycle_update_every` steps). No generator → one
        seeded by `it`."""
        self.field.encoding.set_anneal_iter(it)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(it)
        with torch.no_grad():
            self.accel.step(it, generator, self.query_density)

    def ray_query(self, ray_tested: Dict,
                  generator: Optional[torch.Generator] = None,
                  with_rgb: bool = True, draw: Optional[Draw] = None
                  ) -> Tuple[Dict, Dict]:
        """Render the tested rays. A `generator` (or a `draw` callable,
        which takes precedence) jitters the march; neither marches at the
        step midpoints."""
        from nr3d_lib_tpu_torch.graphics import nerf_ray_query as Q

        cfg = dict(self.ray_query_cfg)
        mode = cfg.pop("query_mode", "march_occ")
        if draw is None and generator is not None:
            draw = uniform_draw(generator)
        fn = {"march_occ": Q.nerf_ray_query_march_occ,
              "march_occ_compressed": Q.nerf_ray_query_march_occ_compressed
              }.get(mode)
        if fn is None:
            raise NotImplementedError(
                f"query_mode {mode!r} is not ported yet (ROADMAP.md A8b)")
        return fn(self, self.accel, self.space, ray_tested,
                  with_rgb=with_rgb, draw=draw, **cfg)
