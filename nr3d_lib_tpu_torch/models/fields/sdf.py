"""LoTD-encoded SDF field (port of nr3d_lib_tpu/models/fields/sdf.py
`LoTDSDF`, brick backend)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.func import vjp

from nr3d_lib_tpu_torch.models.blocks import MLP
from nr3d_lib_tpu_torch.models.grid_encodings.lotd import get_lotd_encoding

__all__ = ["LoTDSDF"]


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
