"""Renderable models of the dynamic field family (port of
nr3d_lib_tpu/models/model_families.py `DynamicPermutoNeuSModel`). The
conditional and generative families and EmerNeRF wait (ROADMAP.md A12).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.graphics.raysample import Draw, uniform_draw
from nr3d_lib_tpu_torch.models.accelerations import OccGridAccelDynamic
from nr3d_lib_tpu_torch.models.model_base import ModelMixin
from nr3d_lib_tpu_torch.models.spatial import AABBDynamicSpace

__all__ = ["DynamicPermutoNeuSModel"]


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
        """Render the tested rays at their `ts`. A `generator` (or a
        `draw` callable, which takes precedence) perturbs the samples, as
        for training; neither renders unperturbed."""
        from nr3d_lib_tpu_torch.graphics.neus_ray_query_variants import \
            neus_ray_query_dynamic

        cfg = dict(self.ray_query_cfg)
        cfg.pop("query_mode", None)
        if draw is None and generator is not None:
            draw = uniform_draw(generator)
        return neus_ray_query_dynamic(self, self.space, ray_tested,
                                      ray_tested["ts"], with_rgb=with_rgb,
                                      draw=draw, **cfg)
