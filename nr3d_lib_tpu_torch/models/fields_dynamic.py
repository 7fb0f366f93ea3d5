"""Dynamic (time-varying) fields (port of nr3d_lib_tpu/models/
fields_dynamic.py `DynamicPermutoConcatSDF`, `DynamicPermutoConcatNeuS`):
t is concatenated onto x as a fourth permutohedral input. EmerNeRF waits
(ROADMAP.md A12).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.func import vjp

from nr3d_lib_tpu_torch.models.blocks import MLP
from nr3d_lib_tpu_torch.models.fields.nerf import RadianceNet
from nr3d_lib_tpu_torch.models.fields.neus import get_neus_var_ctrl
from nr3d_lib_tpu_torch.models.grid_encodings.permuto import PermutoParams

__all__ = ["DynamicPermutoConcatSDF", "DynamicPermutoConcatNeuS"]


def _ts_column(ts, x: torch.Tensor) -> torch.Tensor:
    """ts (scalar, [N] or [..., 1]) → [..., 1] matching x's batch."""
    ts = torch.as_tensor(ts, dtype=x.dtype, device=x.device)
    if ts.dim() <= 1:
        ts = ts.reshape(-1, 1)
    return ts.expand(*x.shape[:-1], 1)


class DynamicPermutoConcatSDF(nn.Module):
    """SDF over (x, t) through a 4D permutohedral table."""

    def __init__(self, *, permuto_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None, n_geo_feat: int = 15,
                 radius_init: float = 0.5, seed: int = 0, device=None):
        super().__init__()
        self.radius_init = float(radius_init)
        cfg = dict(permuto_cfg or {})
        # the classic lattice's log2_hashmap_size waits with that backend
        cfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0, 128.0])
        cfg.setdefault("n_feats", 2)
        self.bank = PermutoParams(
            4, cfg["res_list"], n_feats=cfg["n_feats"],
            backend=cfg.get("backend", "xla"),
            hashmap_rows=cfg.get("hashmap_rows", 4096), seed=seed,
            device=device)
        self.meta = self.bank.meta
        dec = dict(decoder_cfg or {})
        dec.setdefault("D", 1)
        dec.setdefault("W", 64)
        self.decoder = MLP(self.bank.out_features + 3, 1 + n_geo_feat, **dec,
                           seed=seed + 1, device=device)
        self.n_geo_feat = n_geo_feat

    def _inp(self, x: torch.Tensor, ts) -> torch.Tensor:
        return torch.cat([x * 0.5 + 0.5, _ts_column(ts, x) * 0.5 + 0.5], -1)

    def _dec(self, x: torch.Tensor, h_enc: torch.Tensor):
        out = self.decoder(torch.cat([x, h_enc], -1))
        if self.radius_init > 0:
            # geometric init (sphere residual)
            sdf = out[..., 0] + (torch.linalg.norm(x, dim=-1)
                                 - self.radius_init)
        else:
            sdf = out[..., 0]
        return sdf, out[..., 1:]

    def forward_sdf(self, x: torch.Tensor, ts) -> Dict[str, torch.Tensor]:
        """x in [-1,1], ts in [-1,1] → {sdf, h}."""
        sdf, h = self._dec(x, self.bank.encode(self._inp(x, ts)))
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x: torch.Tensor, ts
                           ) -> Dict[str, torch.Tensor]:
        """(sdf, h, nablas=∂sdf/∂x), split as in the JAX cell path: the
        decoder term by `torch.func.vjp`, the (x,t) encoding term by the
        bank's nablas (B13 for F=2, B16 for F=4), of which the spatial
        nablas are the first 3 of the 4 lattice-input gradients, times 0.5
        for x → x·0.5+0.5."""
        inp = self._inp(x, ts)
        h_enc = self.bank.encode(inp)
        (sdf, h), dec_vjp = vjp(self._dec, x, h_enc)
        gx, gh = dec_vjp((torch.ones_like(sdf), torch.zeros_like(h)))
        nablas = gx + 0.5 * self.bank.nablas(gh, inp)[..., :3]
        return {"sdf": sdf, "h": h, "nablas": nablas}


class DynamicPermutoConcatNeuS(nn.Module):
    """Time-conditioned NeuS field: (x, t) SDF + radiance + inv_s."""

    def __init__(self, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0,
                 device=None):
        super().__init__()
        self.implicit_surface = DynamicPermutoConcatSDF(
            **(surface_cfg or {}), seed=seed, device=device)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat, use_nablas=True,
            use_pos=True, **(radiance_cfg or {}), seed=seed + 1,
            device=device)
        self.var_ctrl = get_neus_var_ctrl(
            **(var_ctrl_cfg or {"type": "learned"}), device=device)

    def forward_inv_s(self) -> torch.Tensor:
        return self.var_ctrl.inv_s()

    def forward(self, x: torch.Tensor, v: torch.Tensor, ts,
                with_rgb: bool = True) -> Dict[str, torch.Tensor]:
        out = self.implicit_surface.forward_sdf_nablas(x, ts)
        if with_rgb:
            out["rgb"] = self.radiance(x, v, out["nablas"], out["h"])
        return out
