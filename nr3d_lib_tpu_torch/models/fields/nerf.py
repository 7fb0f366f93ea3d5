"""NeRF field nets (port of nr3d_lib_tpu/models/fields/nerf.py `trunc_exp`,
`RadianceNet`, `LoTDNeRF`, `PermutoNeRF`)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from nr3d_lib_tpu_torch.models.blocks import MLP
from nr3d_lib_tpu_torch.models.embedders import get_embedder

__all__ = ["trunc_exp", "RadianceNet", "LoTDNeRF", "PermutoNeRF"]


class _TruncExp(torch.autograd.Function):
    """exp(clip(x, −15, 15)) whose gradient is g·exp(clip(x, −15, 15)) for
    every x, as the JAX custom_vjp defines it (autograd of exp∘clamp would
    give 0 outside the clip)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(torch.clamp(x, -15.0, 15.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with a clipped input and the NGP trunc_exp gradient."""
    return _TruncExp.apply(x)


class RadianceNet(nn.Module):
    """rgb = MLP([x?, v_embed, n?, h_extra]) with sigmoid output."""

    def __init__(self, *, use_pos: bool = False, use_view_dirs: bool = True,
                 use_nablas: bool = False, n_extra_feat: int = 16,
                 dir_embed_cfg: Optional[dict] = None,
                 D: int = 2, W: int = 64, seed: int = 0, device=None):
        super().__init__()
        self.use_pos = use_pos
        self.use_view_dirs = use_view_dirs
        self.use_nablas = use_nablas
        self.dir_embed_fn, dir_dim = get_embedder(
            dir_embed_cfg or {"type": "spherical", "degree": 4}, 3)
        in_dim = (3 if use_pos else 0) + (dir_dim if use_view_dirs else 0) + \
                 (3 if use_nablas else 0) + n_extra_feat
        self.mlp = MLP(in_dim, 3, D=D, W=W, activation="relu",
                       output_activation="sigmoid", seed=seed, device=device)
        self.in_features = in_dim

    def forward(self, x: Optional[torch.Tensor], v: Optional[torch.Tensor],
                n: Optional[torch.Tensor] = None,
                h_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = []
        if self.use_pos:
            feats.append(x)
        if self.use_view_dirs:
            feats.append(self.dir_embed_fn(v))
        if self.use_nablas:
            feats.append(n)
        if h_extra is not None:
            feats.append(h_extra)
        return self.mlp(torch.cat(feats, -1))


class LoTDNeRF(nn.Module):
    """LoTD-encoded NeRF: brick grid encoding → small density decoder →
    radiance head. Module names mirror the JAX package's (`encoding`,
    `decoder`, `radiance/mlp`), so the state bridge maps them unchanged."""

    def __init__(self, *, encoding_cfg: Optional[dict] = None,
                 density_decoder_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, seed: int = 0, device=None):
        super().__init__()
        from nr3d_lib_tpu_torch.models.grid_encodings.lotd import \
            get_lotd_encoding

        enc_cfg = dict(encoding_cfg or {})
        if "lotd_cfg" not in enc_cfg:
            raise ValueError("encoding_cfg needs a lotd_cfg (the JAX "
                             "default is the unported XLA backend)")
        self.encoding = get_lotd_encoding(3, **enc_cfg, seed=seed,
                                          device=device)
        # NeRF density never differentiates w.r.t. positions (no eikonal),
        # so the brick backward computes dL/dtable only; frozen_x=False
        # keeps the position gradient (pose refinement).
        self._frozen_x = (enc_cfg.get("backend", "xla") == "brick"
                          and bool(enc_cfg.get("frozen_x", True)))
        self.n_geo_feat = n_geo_feat
        dec_cfg = dict(density_decoder_cfg or {})
        dec_cfg.setdefault("D", 1)
        dec_cfg.setdefault("W", 64)
        self.decoder = MLP(self.encoding.out_features, 1 + n_geo_feat,
                           **dec_cfg, seed=seed + 1, device=device)
        self.radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                    **(radiance_cfg or {}), seed=seed + 2,
                                    device=device)

    def forward_density(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x in [-1,1] → {sigma, h}."""
        h = self.decoder(self.encoding(x, frozen_x=self._frozen_x))
        return {"sigma": trunc_exp(h[..., 0]), "h": h[..., 1:]}

    def forward(self, x: torch.Tensor, v: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        out = self.forward_density(x)
        out["rgb"] = self.radiance(x, v, None, out["h"])
        return out


class PermutoNeRF(nn.Module):
    """Permutohedral-encoded NeRF: a 3D cell-permuto table → small density
    decoder → radiance head, the permuto counterpart of `LoTDNeRF`. Only
    the cell backend is ported (`PermutoParams` raises for the classic
    lattice)."""

    def __init__(self, *, permuto_cfg: Optional[dict] = None,
                 density_decoder_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, seed: int = 0, device=None):
        super().__init__()
        from nr3d_lib_tpu_torch.models.grid_encodings.permuto import \
            PermutoParams

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
        dec_cfg = dict(density_decoder_cfg or {})
        dec_cfg.setdefault("D", 1)
        dec_cfg.setdefault("W", 64)
        self.decoder = MLP(self.bank.out_features, 1 + n_geo_feat,
                           **dec_cfg, seed=seed + 1, device=device)
        self.radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                    **(radiance_cfg or {}), seed=seed + 2,
                                    device=device)
        self.n_geo_feat = n_geo_feat

    def forward_density(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x in [-1,1] → {sigma, h}; the lattice sees x·0.5 + 0.5. The
        encode's backward computes dL/dx only when x needs it (B11
        otherwise, on CUDA)."""
        h = self.decoder(self.bank.encode(x * 0.5 + 0.5))
        return {"sigma": trunc_exp(h[..., 0]), "h": h[..., 1:]}

    def forward(self, x: torch.Tensor, v: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        out = self.forward_density(x)
        out["rgb"] = self.radiance(x, v, None, out["h"])
        return out
