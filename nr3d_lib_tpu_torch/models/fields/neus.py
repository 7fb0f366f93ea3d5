"""NeuS field: SDF net + radiance net + inv_s (port of
nr3d_lib_tpu/models/fields/neus.py `LearnedVar` and `LoTDNeuS`)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from nr3d_lib_tpu_torch.models.fields.nerf import RadianceNet
from nr3d_lib_tpu_torch.models.fields.sdf import LoTDSDF

__all__ = ["LearnedVar", "get_neus_var_ctrl", "LoTDNeuS"]


class LearnedVar(nn.Module):
    """Single learnable inv_s = exp(10·ln_s)."""

    def __init__(self, init_val: float = 0.3, device=None):
        super().__init__()
        self.ln_s = nn.Parameter(torch.tensor(math.log(init_val) / 10.0,
                                              dtype=torch.float32,
                                              device=device))

    def inv_s(self) -> torch.Tensor:
        return torch.exp(self.ln_s * 10.0)


def get_neus_var_ctrl(type: str = "learned", device=None, **kwargs):
    t = type.lower()
    if t in ("learned", "single"):
        return LearnedVar(**kwargs, device=device)
    raise NotImplementedError(f"var ctrl {type!r} is not ported yet")


class LoTDNeuS(nn.Module):
    """LoTD-encoded NeuS: joint (sdf, nablas, rgb) forward."""

    def __init__(self, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0,
                 device=None):
        super().__init__()
        self.implicit_surface = LoTDSDF(**(surface_cfg or {}), seed=seed,
                                        device=device)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat,
            use_nablas=True, use_pos=True,
            **(radiance_cfg or {}), seed=seed + 1, device=device)
        self.var_ctrl = get_neus_var_ctrl(
            **(var_ctrl_cfg or {"type": "learned"}), device=device)

    def forward_sdf(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.implicit_surface.forward_sdf(x)

    def forward_inv_s(self) -> torch.Tensor:
        return self.var_ctrl.inv_s()

    def forward(self, x: torch.Tensor, v: Optional[torch.Tensor] = None,
                with_rgb: bool = True, with_nablas: bool = True
                ) -> Dict[str, torch.Tensor]:
        if with_nablas or with_rgb:
            out = self.implicit_surface.forward_sdf_nablas(x)
        else:
            out = self.forward_sdf(x)
        if with_rgb:
            out["rgb"] = self.radiance(x, v, out.get("nablas"), out["h"])
        return out
