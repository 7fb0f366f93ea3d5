"""SDF fields (port of nr3d_lib_tpu/models/fields/sdf.py `LoTDSDF`, brick
backend, and `PermutoSDF`, cell backend)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.func import vjp

from nr3d_lib_tpu_torch.models.blocks import MLP
from nr3d_lib_tpu_torch.models.grid_encodings.lotd import get_lotd_encoding
from nr3d_lib_tpu_torch.models.grid_encodings.permuto import PermutoParams

__all__ = ["LoTDSDF", "PermutoSDF"]


class LoTDSDF(nn.Module):
    """LoTD encoding + small decoder → (sdf, geometry feature)."""

    def __init__(self, *, encoding_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None, n_geo_feat: int = 15,
                 seed: int = 0, device=None):
        super().__init__()
        enc_cfg = dict(encoding_cfg or {})
        if "lotd_cfg" not in enc_cfg:
            raise ValueError("encoding_cfg needs a lotd_cfg (the JAX "
                             "default is the unported XLA backend)")
        self.encoding = get_lotd_encoding(3, **enc_cfg, seed=seed,
                                          device=device)
        dec_cfg = dict(decoder_cfg or {})
        dec_cfg.setdefault("D", 1)
        dec_cfg.setdefault("W", 64)
        dec_cfg.setdefault("activation", "relu")
        self.decoder = MLP(self.encoding.out_features + 3, 1 + n_geo_feat,
                           **dec_cfg, seed=seed + 1, device=device)
        self.n_geo_feat = n_geo_feat

    def _dec(self, x: torch.Tensor, h_enc: torch.Tensor):
        out = self.decoder(torch.cat([x, h_enc], -1))
        return out[..., 0], out[..., 1:]

    def forward_sdf(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x in [-1,1] → {sdf, h}; the decoder also sees raw x."""
        sdf, h = self._dec(x, self.encoding(x))
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(sdf, h, nablas=∂sdf/∂x), split as in the JAX brick path:
        nablas = ∂sdf/∂x_direct + J_encᵀ·∂sdf/∂h_enc, the decoder term by
        `torch.func.vjp` (works under `no_grad`; under outer autograd its
        outputs stay differentiable, so an eikonal loss reaches the decoder
        weights), the encoding term by the encoding's nablas kernel (B8
        for F=2, B3 for F=4; their backwards are B9 and B4)."""
        batch = x.shape[:-1]
        xf = x.reshape(-1, 3)
        h_enc = self.encoding(xf)
        (sdf, h), dec_vjp = vjp(self._dec, xf, h_enc)
        gx, gh = dec_vjp((torch.ones_like(sdf), torch.zeros_like(h)))
        nablas = gx + self.encoding.nablas_path(xf, gh)
        return {"sdf": sdf.reshape(batch),
                "h": h.reshape(*batch, h.shape[-1]),
                "nablas": nablas.reshape(*batch, 3)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_sdf(x)["sdf"]


class PermutoSDF(nn.Module):
    """Static permutohedral-encoded SDF: a 3D cell-permuto table, a small
    decoder over [x, features], and an optional sphere residual
    (|x| − radius_init added to the sdf). Only the cell backend is ported
    (`PermutoParams` raises for the classic lattice)."""

    def __init__(self, *, permuto_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None, n_geo_feat: int = 15,
                 radius_init: float = 0.0, seed: int = 0, device=None):
        super().__init__()
        cfg = dict(permuto_cfg or {})
        # the classic lattice's log2_hashmap_size waits with that backend
        cfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0, 128.0])
        cfg.setdefault("n_feats", 2)
        self.bank = PermutoParams(
            3, cfg["res_list"], n_feats=cfg["n_feats"],
            backend=cfg.get("backend", "xla"),
            hashmap_rows=cfg.get("hashmap_rows", 4096), seed=seed,
            device=device)
        self.meta = self.bank.meta
        dec_cfg = dict(decoder_cfg or {})
        dec_cfg.setdefault("D", 1)
        dec_cfg.setdefault("W", 64)
        self.decoder = MLP(self.bank.out_features + 3, 1 + n_geo_feat,
                           **dec_cfg, seed=seed + 1, device=device)
        self.n_geo_feat = n_geo_feat
        self.radius_init = float(radius_init)

    def _dec(self, x: torch.Tensor, h_enc: torch.Tensor):
        out = self.decoder(torch.cat([x, h_enc], -1))
        sdf = out[..., 0]
        if self.radius_init > 0:
            sdf = sdf + (torch.linalg.norm(x, dim=-1) - self.radius_init)
        return sdf, out[..., 1:]

    def forward_sdf(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x in [-1,1] → {sdf, h}; the lattice sees x·0.5 + 0.5."""
        sdf, h = self._dec(x, self.bank.encode(x * 0.5 + 0.5))
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(sdf, h, nablas=∂sdf/∂x), split as in the JAX cell path: the
        decoder term by `torch.func.vjp`, the encoding term by the bank's
        nablas (B13 for F=2, B16 for F=4), times 0.5 for x → x·0.5+0.5."""
        batch = x.shape[:-1]
        xf = x.reshape(-1, 3)
        x01 = xf * 0.5 + 0.5
        h_enc = self.bank.encode(x01)
        (sdf, h), dec_vjp = vjp(self._dec, xf, h_enc)
        gx, gh = dec_vjp((torch.ones_like(sdf), torch.zeros_like(h)))
        nablas = gx + 0.5 * self.bank.nablas(gh, x01)
        return {"sdf": sdf.reshape(batch),
                "h": h.reshape(*batch, h.shape[-1]),
                "nablas": nablas.reshape(*batch, 3)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_sdf(x)["sdf"]
