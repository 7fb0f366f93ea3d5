"""MLP block (port of nr3d_lib_tpu/models/blocks.py `MLP`).

Weights are stored as JAX stores them, `ws[i]` of shape [in, out] and
`bs[i]` of shape [out], and applied as `h @ w + b`, so the state bridge
copies them without a transpose. Initial values follow the JAX package's
default scheme (truncated-normal, std 1/√in; zero bias) from an explicit
`torch.Generator`; they do not match JAX's random bits, and tests carry
weights across through `bridge.from_jax_state`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["get_nonlinearity", "MLP"]

_NONLIN = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "identity": None, "none": None, "linear": None,
}


def get_nonlinearity(name: Optional[str]):
    if name is None:
        return None
    key = str(name).lower()
    if key not in _NONLIN:
        raise NotImplementedError(f"activation {name!r} is not ported yet")
    return _NONLIN[key]


class MLP(nn.Module):
    """Plain MLP with optional skip connections (the input is concatenated
    onto the hidden state before each layer listed in `skips`)."""

    def __init__(self, in_features: int, out_features: int, *,
                 D: int = 4, W: int = 128, skips: Sequence[int] = (),
                 activation: str = "relu",
                 output_activation: Optional[str] = None,
                 seed: int = 0, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.D, self.W = D, W
        self.skips = tuple(skips)
        self.activation = get_nonlinearity(activation)
        self.output_activation = get_nonlinearity(output_activation)
        gen = torch.Generator().manual_seed(seed)
        dims = [in_features] + [W] * D + [out_features]
        ws, bs = [], []
        for i in range(len(dims) - 1):
            n_in = dims[i] + (in_features if i in self.skips else 0)
            w = torch.empty(n_in, dims[i + 1])
            nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
            ws.append(nn.Parameter((w / math.sqrt(n_in)).to(device)))
            bs.append(nn.Parameter(torch.zeros(dims[i + 1], device=device)))
        self.ws = nn.ParameterList(ws)
        self.bs = nn.ParameterList(bs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.ws)
        for i in range(n):
            if i in self.skips:
                h = torch.cat([h, x], -1)
            h = h @ self.ws[i] + self.bs[i]
            if i < n - 1 and self.activation is not None:
                h = self.activation(h)
        if self.output_activation is not None:
            h = self.output_activation(h)
        return h
