"""ModelMixin lifecycle API + the LoTD NeuS model (port of
nr3d_lib_tpu/models/model_base.py `ModelMixin`, `LoTDNeuSModel`).

A renderable model owns (field net, space, accel) and dispatches
`ray_query` to the strategy function of its query mode. Only the
`march_occ_multi_upsample_compressed` mode is ported; the others raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.models.accelerations import OccGridAccel
from nr3d_lib_tpu_torch.models.spatial import AABBSpace

__all__ = ["ModelMixin", "LoTDNeuSModel"]


class ModelMixin:
    """Lifecycle protocol: populate → ray_test → ray_query. The model
    provides `space` (and `accel`) as submodules."""

    def populate(self, **kwargs):
        pass

    def ray_test(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 near=None, far=None) -> Dict:
        return self.space.ray_test(rays_o, rays_d, near=near, far=far)

    def ray_query(self, ray_tested: Dict, with_rgb: bool = True
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

    def ray_query(self, ray_tested: Dict, with_rgb: bool = True
                  ) -> Tuple[Dict, Dict]:
        cfg = dict(self.ray_query_cfg)
        mode = cfg.pop("query_mode", "march_occ_multi_upsample")
        if mode == "march_occ_multi_upsample_compressed":
            from nr3d_lib_tpu_torch.graphics.neus_ray_query_variants import (
                neus_ray_query_march_occ_multi_upsample_compressed)

            return neus_ray_query_march_occ_multi_upsample_compressed(
                self, self.accel, self.space, ray_tested, with_rgb=with_rgb,
                **cfg)
        raise NotImplementedError(
            f"query_mode {mode!r} is not ported yet (ROADMAP.md A8)")
