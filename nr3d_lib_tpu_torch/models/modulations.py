"""FiLM-SIREN modulation layers and their mapping network (port of
nr3d_lib_tpu/models/modulations.py `FiLMLayer`, `MappingNetwork`,
`FiLMSiren`): a latent z becomes per-layer (frequency, phase) parameters
that modulate SIREN layers (pi-GAN style).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.models.blocks import MLP

__all__ = ["FiLMLayer", "FiLMSiren", "MappingNetwork"]


class FiLMLayer(nn.Module):
    """sin(γ·(x W + b) + β), γ scaled by w0 on the first layer. `w` [in,
    out] is U(±1/in) on the first layer and U(±√(6/in)/w0) after it, from
    a seeded generator (not JAX's bits: weights cross by the bridge).
    `device=None` means CUDA."""

    def __init__(self, in_features: int, out_features: int, *,
                 is_first: bool = False, w0: float = 30.0, seed: int = 0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        bound = 1.0 / in_features if is_first else \
            math.sqrt(6.0 / in_features) / w0
        gen = torch.Generator().manual_seed(seed)
        w = (torch.rand(in_features, out_features, generator=gen) * 2.0
             - 1.0) * bound
        self.w = nn.Parameter(w.to(device))
        self.b = nn.Parameter(torch.zeros(out_features, device=device))
        self.w0 = w0
        self.is_first = is_first

    def forward(self, x: torch.Tensor, freq: torch.Tensor,
                phase: torch.Tensor) -> torch.Tensor:
        h = x @ self.w + self.b
        scale = self.w0 if self.is_first else 1.0
        return torch.sin(scale * freq * h + phase)


class MappingNetwork(nn.Module):
    """z → per-layer (freq [..., n_layers, hidden], phase): an MLP whose
    output is split in two, freq scaled as 15·f + 30. `device=None`
    means CUDA."""

    def __init__(self, z_dim: int, n_layers: int, hidden: int, *,
                 map_layers: int = 3, map_hidden: int = 256, seed: int = 0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.n_layers = n_layers
        self.hidden = hidden
        self.mlp = MLP(z_dim, n_layers * hidden * 2, D=map_layers,
                       W=map_hidden, activation="relu", seed=seed,
                       device=device)

    def forward(self, z: torch.Tensor):
        out = self.mlp(z).reshape(*z.shape[:-1], self.n_layers, 2,
                                  self.hidden)
        return out[..., 0, :] * 15.0 + 30.0, out[..., 1, :]


class FiLMSiren(nn.Module):
    """A latent-modulated SIREN: D FiLM layers of width W, the mapping
    network, a linear output. z [..., z_dim] modulates x [..., N, in] (a
    latent per batch row) or x [..., in] (a latent per point).
    `device=None` means CUDA."""

    def __init__(self, in_features: int, out_features: int, z_dim: int, *,
                 D: int = 4, W: int = 128, w0: float = 30.0, seed: int = 0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.layers = nn.ModuleList([
            FiLMLayer(in_features if i == 0 else W, W, is_first=(i == 0),
                      w0=w0, seed=seed + i, device=device)
            for i in range(D)])
        self.mapping = MappingNetwork(z_dim, D, W, seed=seed + 100,
                                      device=device)
        self.out = MLP(W, out_features, D=0, W=W, seed=seed + 200,
                       device=device)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        freq, phase = self.mapping(z)
        h = x
        for i, layer in enumerate(self.layers):
            f, p = freq[..., i, :], phase[..., i, :]
            if f.dim() < h.dim():
                f, p = f[..., None, :], p[..., None, :]
            h = layer(h, f, p)
        return self.out(h)
