"""Radiance head (port of nr3d_lib_tpu/models/fields/nerf.py
`RadianceNet`)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nr3d_lib_tpu_torch.models.blocks import MLP
from nr3d_lib_tpu_torch.models.embedders import get_embedder

__all__ = ["RadianceNet"]


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
