"""Conditional (generative, categorical) fields (port of nr3d_lib_tpu/
models/fields_conditional.py `GenerativePermutoConcatSDF`,
`GenerativePermutoConcatNeuS`, `StyleLoTDSDF`, `StyleLoTDNeuS`, and the
`LoTDDenseGrower` alias).

The concat family feeds [x, tanh(z)] into one (3 + z_dim)-dimensional
permutohedral table: the classic lattice by default (plain PyTorch, as
XLA in JAX), or the F=2 cell layout when 3 + z_dim ≤ 5 (`backend: cell`:
B10 forward, B11/B12 backward, B13 nablas on the card). The style family
grows per-instance LoTD parameters from z with a grower and encodes each
point with its instance's (`lotd_encode(..., bidx=)`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from nr3d_lib_tpu_torch.models.blocks import MLP
from nr3d_lib_tpu_torch.models.fields.neus import ConditionedNeuS
from nr3d_lib_tpu_torch.models.fields.sdf import (SphereResidualDecoder,
                                                  autograd_nablas)
from nr3d_lib_tpu_torch.models.grid_encodings.lotd.lotd_growers import (
    LoTDFlattenGrower as LoTDDenseGrower, get_lotd_grower)
from nr3d_lib_tpu_torch.models.grid_encodings.permuto import PermutoParams
from nr3d_lib_tpu_torch.ops import lotd as _lotd

__all__ = ["GenerativePermutoConcatSDF", "GenerativePermutoConcatNeuS",
           "LoTDDenseGrower", "StyleLoTDSDF", "StyleLoTDNeuS",
           "concat_bank"]


def concat_bank(n_dims: int, permuto_cfg: Optional[dict], seed: int,
                device) -> PermutoParams:
    """The concat fields' table over [x, z(, t)] with their defaults: res
    [8, 16, 32, 64], 2 features, 2^16 entries a level, the classic
    lattice unless `backend` says `cell`."""
    cfg = dict(permuto_cfg or {})
    cfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0])
    cfg.setdefault("n_feats", 2)
    cfg.setdefault("log2_hashmap_size", 16)
    return PermutoParams(
        n_dims, cfg["res_list"], n_feats=cfg["n_feats"],
        log2_hashmap_size=cfg["log2_hashmap_size"],
        backend=cfg.get("backend", "xla"),
        hashmap_rows=cfg.get("hashmap_rows", 4096), seed=seed, device=device)


class GenerativePermutoConcatSDF(SphereResidualDecoder):
    """SDF conditioned by concatenating tanh(z·z_scale) onto x in the
    permutohedral input. `backend: cell` needs 3 + z_dim ≤ 5 (the cell
    row packs 2^(d+1) vertex slots into 128 lanes)."""

    def __init__(self, z_dim: int = 4, *,
                 permuto_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, z_scale: float = 1.0,
                 radius_init: float = 0.5, seed: int = 0, device=None):
        super().__init__()
        self.bank = concat_bank(3 + z_dim, permuto_cfg, seed, device)
        self.meta = self.bank.meta
        self.z_dim = z_dim
        self.z_scale = z_scale
        self._init_decoder(self.bank.out_features, decoder_cfg, n_geo_feat,
                           radius_init, seed, device)

    def _inp(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        z = z.expand(*x.shape[:-1], self.z_dim)
        return torch.cat([x * 0.5 + 0.5,
                          torch.tanh(z * self.z_scale) * 0.5 + 0.5], -1)

    def forward_sdf(self, x: torch.Tensor, z: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """x [..., 3] in [-1,1]; z [..., z_dim] broadcastable to x's
        batch → {sdf, h}."""
        sdf, h = self._dec(x, self.bank(self._inp(x, z)))
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x: torch.Tensor, z: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        return self._sdf_nablas(x, lambda xx: self._inp(xx, z))


class GenerativePermutoConcatNeuS(ConditionedNeuS):
    """The generative SDF with a radiance net and inv_s;
    `forward(x, v, z)`."""

    def __init__(self, z_dim: int = 4, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0,
                 device=None):
        super().__init__(GenerativePermutoConcatSDF(
            z_dim, **(surface_cfg or {}), seed=seed, device=device),
            radiance_cfg, var_ctrl_cfg, seed, device)


class StyleLoTDSDF(nn.Module):
    """Per-instance LoTD parameters from a grower, a shared decoder."""

    def __init__(self, z_dim: int = 64, *, lotd_cfg: Optional[dict] = None,
                 grower_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, seed: int = 0, device=None):
        super().__init__()
        cfg = dict(lotd_cfg or {})
        cfg.setdefault("lod_res", [8, 16, 32])
        cfg.setdefault("lod_n_feats", 2)
        cfg.setdefault("lod_types", "Dense")
        self.meta = _lotd.generate_meta(3, cfg["lod_res"], cfg["lod_n_feats"],
                                        cfg["lod_types"],
                                        hashmap_size=cfg.get("hashmap_size"))
        gcfg = dict(grower_cfg or {})
        gtype = gcfg.pop("type", "flatten")
        gcfg.setdefault("seed", seed)
        self.grower = get_lotd_grower(gtype, z_dim, self.meta, **gcfg,
                                      device=device)
        dec = dict(decoder_cfg or {})
        dec.setdefault("D", 1)
        dec.setdefault("W", 64)
        self.decoder = MLP(self.meta.out_features + 3, 1 + n_geo_feat, **dec,
                           seed=seed + 1, device=device)
        self.n_geo_feat = n_geo_feat

    def _sdf_h(self, x: torch.Tensor, z: torch.Tensor,
               bidx: Optional[torch.Tensor]):
        """x [N,3] in [-1,1]; z [B, z_dim] the instance table; bidx [N]
        each point's instance (None: instance 0)."""
        params = self.grower(z)                              # [B, n_params]
        if bidx is None:
            bidx = torch.zeros(x.shape[:-1], dtype=torch.int64,
                               device=x.device)
        h = _lotd.lotd_encode(x * 0.5 + 0.5, params, self.meta, bidx=bidx)
        out = self.decoder(torch.cat([x, h], -1))
        return out[..., 0], out[..., 1:]

    def forward_sdf(self, x: torch.Tensor, z: torch.Tensor,
                    bidx: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        sdf, h = self._sdf_h(x, z, bidx)
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x: torch.Tensor, z: torch.Tensor,
                           bidx: Optional[torch.Tensor] = None
                           ) -> Dict[str, torch.Tensor]:
        sdf, h, nablas = autograd_nablas(lambda xx: self._sdf_h(xx, z, bidx),
                                         x)
        return {"sdf": sdf, "h": h, "nablas": nablas}


class StyleLoTDNeuS(ConditionedNeuS):
    """The style SDF with a radiance net and inv_s; `forward(x, v, z,
    bidx)`: z is the per-instance latent table [B, z_dim], bidx [N] each
    point's instance (the grower runs once per instance)."""

    def __init__(self, z_dim: int = 64, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0,
                 device=None):
        super().__init__(StyleLoTDSDF(z_dim, **(surface_cfg or {}),
                                      seed=seed, device=device),
                         radiance_cfg, var_ctrl_cfg, seed, device)
