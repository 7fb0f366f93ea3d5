"""MLP block (port of nr3d_lib_tpu/models/blocks.py `MLP` and
`get_nonlinearity`).

Weights are stored as JAX stores them, `ws[i]` of shape [in, out] and
`bs[i]` of shape [out], and applied as `h @ w + b`, so the state bridge
copies them without a transpose. Initial values follow the JAX package's
schemes (truncated-normal, std 1/√in, zero bias; with `activation="sine"`
the SIREN init) from an explicit `torch.Generator`; they do not match
JAX's random bits, and tests carry weights across through
`bridge.from_jax_state`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["get_nonlinearity", "MLP"]

_NONLIN = {
    "relu": torch.relu,
    # beta = 100, a smooth ReLU (the SDF decoders' standard)
    "softplus": lambda x: F.softplus(100.0 * x) / 100.0,
    "softplus_raw": F.softplus,
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "elu": F.elu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu, "swish": F.silu,
    "sine": torch.sin, "identity": None, "none": None, "linear": None,
    "squareplus": lambda x: 0.5 * (x + torch.sqrt(x * x + 4.0)),
}


def get_nonlinearity(name: Optional[Union[str, Callable]]):
    """Name → activation (a callable passes through, None stays None)."""
    if name is None or callable(name):
        return name
    return _NONLIN[str(name).lower()]


class MLP(nn.Module):
    """Plain MLP with optional skip connections (the input is concatenated
    onto the hidden state before each layer listed in `skips`). With
    `activation="sine"` the first layer computes sin(sine_w0 · h), the
    others sin(h)."""

    def __init__(self, in_features: int, out_features: int, *,
                 D: int = 4, W: int = 128, skips: Sequence[int] = (),
                 activation: str = "relu",
                 output_activation: Optional[str] = None,
                 sine_w0: float = 30.0, seed: int = 0, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.D, self.W = D, W
        self.skips = tuple(skips)
        self.activation_name = activation
        self.activation = get_nonlinearity(activation)
        self.output_activation = get_nonlinearity(output_activation)
        self.sine_w0 = sine_w0
        gen = torch.Generator().manual_seed(seed)
        dims = [in_features] + [W] * D + [out_features]
        ws, bs = [], []
        for i in range(len(dims) - 1):
            n_in = dims[i] + (in_features if i in self.skips else 0)
            if activation == "sine":
                # SIREN: U(±1/in) on the first layer, U(±√(6/in)/w0)
                # after it; bias U(±1)/√in
                bound = (1.0 / n_in) if i == 0 else \
                    (math.sqrt(6.0 / n_in) / sine_w0)
                w = (torch.rand(n_in, dims[i + 1], generator=gen) * 2.0
                     - 1.0) * bound
                b = (torch.rand(dims[i + 1], generator=gen) * 2.0 - 1.0) / \
                    math.sqrt(n_in)
            else:
                w = torch.empty(n_in, dims[i + 1])
                nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0,
                                      generator=gen)
                w = w / math.sqrt(n_in)
                b = torch.zeros(dims[i + 1])
            ws.append(nn.Parameter(w.to(device)))
            bs.append(nn.Parameter(b.to(device)))
        self.ws = nn.ParameterList(ws)
        self.bs = nn.ParameterList(bs)

    def get_weight_reg(self, norm_type: float = 2.0) -> torch.Tensor:
        """Each layer's weight norm (sum |w|^p)^(1/p), stacked [n_layers]:
        trainers sum these as a decay loss."""
        return torch.stack([torch.sum(torch.abs(w) ** norm_type)
                            ** (1.0 / norm_type) for w in self.ws])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.ws)
        for i in range(n):
            if i in self.skips:
                h = torch.cat([h, x], -1)
            h = h @ self.ws[i] + self.bs[i]
            if i < n - 1:
                if self.activation_name == "sine":
                    h = torch.sin(self.sine_w0 * h) if i == 0 else \
                        torch.sin(h)
                elif self.activation is not None:
                    h = self.activation(h)
        if self.output_activation is not None:
            h = self.output_activation(h)
        return h
