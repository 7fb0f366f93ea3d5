"""MLP blocks (port of nr3d_lib_tpu/models/blocks.py: `MLP`,
`LipshitzMLP`, `get_blocks` and `get_nonlinearity`).

Weights are stored as JAX stores them, `ws[i]` of shape [in, out] and
`bs[i]` of shape [out], and applied as `h @ w + b`, so the state bridge
copies them without a transpose. Initial values follow the JAX package's
schemes (truncated-normal, std 1/√in, zero bias; with `activation="sine"`
the SIREN init; with `geometric_init` the SDF sphere init, which makes the
net ≈ |x| − radius_init at the start) from an explicit `torch.Generator`;
they do not match JAX's random bits, and tests carry weights across
through `bridge.from_jax_state`.

`param_dtype` is the parameters' dtype and `compute_dtype` the forward's:
the input and each layer's weight and bias are cast to it (None: the
input's dtype), at the JAX package's points. A dtype is a `torch.dtype`
or its name ("bfloat16").
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["get_nonlinearity", "MLP", "LipshitzMLP", "get_blocks",
           "as_dtype"]

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


def as_dtype(dtype: Optional[Union[str, torch.dtype]]
             ) -> Optional[torch.dtype]:
    """None, a `torch.dtype`, or a dtype's name → a `torch.dtype` (or
    None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype).split(".")[-1], None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"not a dtype: {dtype!r}")
    return out


def _init_linear(gen: torch.Generator, n_in: int, n_out: int, *,
                 activation: str, is_first: bool, is_last: bool,
                 geometric_init: bool = False, radius_init: float = 0.5,
                 sine_w0: float = 30.0):
    """One layer's float32 (w [n_in, n_out], b [n_out]): the geometric
    (SDF sphere) init, the SIREN init, or truncated-normal std 1/√n_in
    with a zero bias."""
    if geometric_init:
        if is_last:
            # every output ≈ √π/√n_in · Σ h − radius_init
            w = math.sqrt(math.pi) / math.sqrt(n_in) + 1e-4 * torch.randn(
                n_in, n_out, generator=gen)
            b = torch.full((n_out,), -float(radius_init))
        else:
            w = math.sqrt(2.0) / math.sqrt(n_out) * torch.randn(
                n_in, n_out, generator=gen)
            b = torch.zeros(n_out)
            if is_first and n_in > 3:
                w[3:, :] = 0.0     # only xyz reach the first layer
        return w, b
    if activation == "sine":
        # SIREN: U(±1/in) on the first layer, U(±√(6/in)/w0) after it;
        # bias U(±1)/√in
        bound = (1.0 / n_in) if is_first else (math.sqrt(6.0 / n_in) /
                                               sine_w0)
        w = (torch.rand(n_in, n_out, generator=gen) * 2.0 - 1.0) * bound
        b = (torch.rand(n_out, generator=gen) * 2.0 - 1.0) / math.sqrt(n_in)
        return w, b
    w = torch.empty(n_in, n_out)
    nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
    return w / math.sqrt(n_in), torch.zeros(n_out)


class MLP(nn.Module):
    """Plain MLP with optional skip connections (the input is concatenated
    onto the hidden state before each layer listed in `skips`). With
    `activation="sine"` the first layer computes sin(sine_w0 · h), the
    others sin(h)."""

    def __init__(self, in_features: int, out_features: int, *,
                 D: int = 4, W: int = 128, skips: Sequence[int] = (),
                 activation: str = "relu",
                 output_activation: Optional[str] = None,
                 geometric_init: bool = False, radius_init: float = 0.5,
                 sine_w0: float = 30.0, compute_dtype=None,
                 param_dtype=torch.float32, seed: int = 0, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.D, self.W = D, W
        self.skips = tuple(skips)
        self.activation_name = activation
        self.activation = get_nonlinearity(activation)
        self.output_activation = get_nonlinearity(output_activation)
        self.sine_w0 = sine_w0
        self.compute_dtype = as_dtype(compute_dtype)
        pdt = as_dtype(param_dtype)
        gen = torch.Generator().manual_seed(seed)
        dims = [in_features] + [W] * D + [out_features]
        ws, bs = [], []
        for i in range(len(dims) - 1):
            n_in = dims[i] + (in_features if i in self.skips else 0)
            w, b = _init_linear(gen, n_in, dims[i + 1], activation=activation,
                                is_first=(i == 0),
                                is_last=(i == len(dims) - 2),
                                geometric_init=geometric_init,
                                radius_init=radius_init, sine_w0=sine_w0)
            ws.append(nn.Parameter(w.to(device=device, dtype=pdt)))
            bs.append(nn.Parameter(b.to(device=device, dtype=pdt)))
        self.ws = nn.ParameterList(ws)
        self.bs = nn.ParameterList(bs)

    def get_weight_reg(self, norm_type: float = 2.0) -> torch.Tensor:
        """Each layer's weight norm (sum |w|^p)^(1/p), stacked [n_layers]:
        trainers sum these as a decay loss."""
        return torch.stack([torch.sum(torch.abs(w) ** norm_type)
                            ** (1.0 / norm_type) for w in self.ws])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype or x.dtype
        h = inp = x.to(cdt)
        n = len(self.ws)
        for i in range(n):
            if i in self.skips:
                h = torch.cat([h, inp], -1)
            h = h @ self.ws[i].to(cdt) + self.bs[i].to(cdt)
            if i < n - 1:
                if self.activation_name == "sine":
                    h = torch.sin(self.sine_w0 * h) if i == 0 else \
                        torch.sin(h)
                elif self.activation is not None:
                    h = self.activation(h)
        if self.output_activation is not None:
            h = self.output_activation(h)
        return h


class LipshitzMLP(nn.Module):
    """MLP with a learnable Lipschitz bound a layer: each layer's weight
    is scaled so that its largest column sum of |w| stays ≤ softplus(c_i).
    `cs[i]` [1] starts at softplus⁻¹ of the initial weight's bound."""

    def __init__(self, in_features: int, out_features: int, *,
                 D: int = 4, W: int = 128, activation: str = "relu",
                 output_activation: Optional[str] = None,
                 param_dtype=torch.float32, seed: int = 0, device=None):
        super().__init__()
        self.activation = get_nonlinearity(activation)
        self.output_activation = get_nonlinearity(output_activation)
        pdt = as_dtype(param_dtype)
        gen = torch.Generator().manual_seed(seed)
        dims = [in_features] + [W] * D + [out_features]
        ws, bs, cs = [], [], []
        for i in range(len(dims) - 1):
            w, b = _init_linear(gen, dims[i], dims[i + 1],
                                activation=activation, is_first=(i == 0),
                                is_last=(i == len(dims) - 2))
            w, b = w.to(pdt), b.to(pdt)
            ci = torch.amax(torch.sum(torch.abs(w), 0))
            c = torch.log(torch.exp(ci) - 1.0 + 1e-6)[None]
            for lst, t in ((ws, w), (bs, b), (cs, c)):
                lst.append(nn.Parameter(t.to(device)))
        self.ws = nn.ParameterList(ws)
        self.bs = nn.ParameterList(bs)
        self.cs = nn.ParameterList(cs)

    def lipshitz_bound_full(self) -> torch.Tensor:
        """The product of the layers' bounds softplus(c_i)."""
        out = torch.ones((), device=self.cs[0].device)
        for c in self.cs:
            out = out * F.softplus(c[0])
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.ws)
        for i in range(n):
            w, b = self.ws[i], self.bs[i]
            bound = F.softplus(self.cs[i][0])
            scale = torch.clamp(bound / torch.clamp(
                torch.amax(torch.sum(torch.abs(w), 0)), min=1e-12), max=1.0)
            h = h @ (w * scale) + b
            if i < n - 1 and self.activation is not None:
                h = self.activation(h)
        if self.output_activation is not None:
            h = self.output_activation(h)
        return h


def get_blocks(in_features: int, out_features: int, *, type: str = "mlp",
               **kwargs) -> nn.Module:
    """Block factory: "mlp" (or "fcblock") → `MLP`, "lipshitz" →
    `LipshitzMLP`; an unknown type raises ValueError."""
    t = type.lower()
    if t in ("mlp", "fcblock"):
        return MLP(in_features, out_features, **kwargs)
    if t == "lipshitz":
        return LipshitzMLP(in_features, out_features, **kwargs)
    raise ValueError(f"Unknown block type: {type}")
