"""NeuS math: logistic-CDF SDF → alpha (port of
nr3d_lib_tpu/graphics/neus.py `neus_cdf`, `neus_ray_sdf_to_alpha`)."""

from __future__ import annotations

import torch

__all__ = ["neus_cdf", "neus_ray_sdf_to_alpha"]


def neus_cdf(sdf: torch.Tensor, inv_s) -> torch.Tensor:
    return torch.sigmoid(sdf * inv_s)


def neus_ray_sdf_to_alpha(sdf: torch.Tensor, inv_s,
                          append_cdf_1: bool = False) -> torch.Tensor:
    """sdf [..., S] → alpha: S-1 intervals, or S with an appended cdf=1."""
    cdf = neus_cdf(sdf, inv_s)
    if append_cdf_1:
        nxt = torch.cat([cdf[..., 1:], torch.ones_like(cdf[..., :1])], -1)
        alpha = (cdf - nxt) / (cdf + 1e-5)
    else:
        alpha = (cdf[..., :-1] - cdf[..., 1:]) / (cdf[..., :-1] + 1e-5)
    return torch.clamp(alpha, min=0.0)
