"""Conditional + dynamic fields (port of nr3d_lib_tpu/models/
fields_conditional_dynamic.py `DynamicGenerativePermutoConcatSDF`,
`DynamicGenerativePermutoConcatNeuS`): the instance latent z and the
timestamp t are both concatenated onto x, a (3 + z_dim + 1)-dimensional
permutohedral input (the classic lattice by default; the cell layout needs
3 + z_dim + 1 ≤ 5).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nr3d_lib_tpu_torch.models.fields.neus import ConditionedNeuS
from nr3d_lib_tpu_torch.models.fields_conditional import (
    SphereResidualDecoder, concat_bank)
from nr3d_lib_tpu_torch.models.fields_dynamic import _ts_column

__all__ = ["DynamicGenerativePermutoConcatSDF",
           "DynamicGenerativePermutoConcatNeuS"]


class DynamicGenerativePermutoConcatSDF(SphereResidualDecoder):
    """SDF over (x, z, t) through one permutohedral table."""

    def __init__(self, z_dim: int = 4, *, permuto_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, z_scale: float = 1.0,
                 radius_init: float = 0.5, seed: int = 0, device=None):
        super().__init__()
        self.bank = concat_bank(3 + z_dim + 1, permuto_cfg, seed, device)
        self.meta = self.bank.meta
        self.z_dim = z_dim
        self.z_scale = z_scale
        self._init_decoder(self.bank.out_features, decoder_cfg, n_geo_feat,
                           radius_init, seed, device)

    def _inp(self, x: torch.Tensor, z: torch.Tensor, ts) -> torch.Tensor:
        z = z.expand(*x.shape[:-1], self.z_dim)
        return torch.cat([x * 0.5 + 0.5,
                          torch.tanh(z * self.z_scale) * 0.5 + 0.5,
                          _ts_column(ts, x) * 0.5 + 0.5], -1)

    def forward_sdf(self, x: torch.Tensor, z: torch.Tensor, ts
                    ) -> Dict[str, torch.Tensor]:
        sdf, h = self._dec(x, self.bank(self._inp(x, z, ts)))
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x: torch.Tensor, z: torch.Tensor, ts
                           ) -> Dict[str, torch.Tensor]:
        return self._sdf_nablas(x, lambda xx: self._inp(xx, z, ts))


class DynamicGenerativePermutoConcatNeuS(ConditionedNeuS):
    """The (x, z, t) SDF with a radiance net and inv_s;
    `forward(x, v, z, ts)`."""

    def __init__(self, z_dim: int = 4, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0,
                 device=None):
        super().__init__(DynamicGenerativePermutoConcatSDF(
            z_dim, **(surface_cfg or {}), seed=seed, device=device),
            radiance_cfg, var_ctrl_cfg, seed, device)
