"""Direction and position embedders (port of nr3d_lib_tpu/models/
embedders.py): identity, the spherical-harmonics basis and the
sinusoidal (frequency) encoding with its annealed window."""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["sh_encode", "freq_encode", "annealed_freq_encode",
           "get_embedder", "SHEncoder", "FreqEncoder"]


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical-harmonics basis of unit directions, NGP component
    order. degree ∈ [1,4] → 1/4/9/16 dims."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]  # l=0
    if degree > 1:
        out += [-0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree > 2:
        xy, yz, xz = x * y, y * z, x * z
        x2, y2, z2 = x * x, y * y, z * z
        out += [1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz,
                0.54627421529603959 * (x2 - y2)]
    if degree > 3:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, -1)


def freq_encode(x: torch.Tensor, n_frequencies: int = 6,
                include_input: bool = True) -> torch.Tensor:
    """[sin, cos](2^i·x), per input dimension [sin(f0..fF) | cos(f0..fF)];
    `include_input` puts x first."""
    freqs = 2.0 ** torch.arange(n_frequencies, dtype=x.dtype,
                                device=x.device)
    xb = x[..., None] * freqs                                     # [..., D, F]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], -1)           # [..., D, 2F]
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], -1)
    return enc


def annealed_freq_encode(x: torch.Tensor, n_frequencies: int, alpha,
                         include_input: bool = True) -> torch.Tensor:
    """The coarse-to-fine windowed frequencies (the BARF/Nerfies window),
    alpha ∈ [0, F]: band i is weighted ½(1 − cos(π·clip(alpha − i, 0,
    1)))."""
    enc = freq_encode(x, n_frequencies, include_input=False)
    d = x.shape[-1]
    bands = torch.arange(n_frequencies, dtype=x.dtype, device=x.device)
    w = torch.clamp(torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
                    - bands, 0.0, 1.0)
    w = 0.5 * (1.0 - torch.cos(math.pi * w))                     # [F]
    w_full = torch.cat([w, w]).repeat(d)
    enc = enc * w_full
    if include_input:
        enc = torch.cat([x, enc], -1)
    return enc


class SHEncoder:
    def __init__(self, degree: int = 4, input_dim: int = 3):
        if input_dim != 3:
            raise ValueError("spherical harmonics take 3-D directions")
        self.degree = degree
        self.in_features = 3
        self.out_features = degree ** 2

    def __call__(self, dirs: torch.Tensor) -> torch.Tensor:
        return sh_encode(dirs, self.degree)


class FreqEncoder:
    """Module-style wrapper of `freq_encode` (`annealed`: the window of
    `annealed_freq_encode` when called with an alpha)."""

    def __init__(self, input_dim: int = 3, n_frequencies: int = 6,
                 include_input: bool = True, annealed: bool = False):
        self.input_dim = input_dim
        self.n_frequencies = n_frequencies
        self.include_input = include_input
        self.annealed = annealed
        self.in_features = input_dim
        self.out_features = input_dim * 2 * n_frequencies + \
            (input_dim if include_input else 0)

    def __call__(self, x: torch.Tensor, alpha=None) -> torch.Tensor:
        if self.annealed and alpha is not None:
            return annealed_freq_encode(x, self.n_frequencies, alpha,
                                        self.include_input)
        return freq_encode(x, self.n_frequencies, self.include_input)


def get_embedder(embed_cfg: Optional[dict] = None, input_dim: int = 3):
    """Embedder factory → (fn, out_features)."""
    cfg = dict(embed_cfg or {})
    etype = cfg.pop("type", "identity").lower()
    if etype in ("identity", "none"):
        return (lambda x: x), input_dim
    if etype in ("spherical", "sh", "spherical_harmonics"):
        enc = SHEncoder(degree=cfg.get("degree", 4), input_dim=input_dim)
        return enc, enc.out_features
    if etype in ("sinusoidal", "freq", "frequency"):
        enc = FreqEncoder(input_dim=input_dim,
                          n_frequencies=cfg.get("n_frequencies", 6),
                          include_input=cfg.get("include_input", True),
                          annealed=cfg.get("annealed", False))
        return enc, enc.out_features
    raise ValueError(f"Unknown embedder type: {etype}")
