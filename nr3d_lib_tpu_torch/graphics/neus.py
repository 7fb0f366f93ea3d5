"""NeuS math: logistic-CDF SDF → alpha (port of
nr3d_lib_tpu/graphics/neus.py `neus_cdf`, `neus_ray_sdf_to_alpha`,
`neus_packed_sdf_to_alpha`)."""

from __future__ import annotations

import torch

__all__ = ["neus_cdf", "neus_ray_sdf_to_alpha", "neus_packed_sdf_to_alpha"]


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


def neus_packed_sdf_to_alpha(sdf: torch.Tensor, inv_s, ridx: torch.Tensor,
                             append_cdf_1: bool = True) -> torch.Tensor:
    """Packed form: the forward difference of the cdf within each pack
    (ridx, packs contiguous); a pack's last sample differences against
    cdf = 1 with `append_cdf_1` (its alpha covers to infinity), else
    against itself (alpha 0)."""
    cdf = neus_cdf(sdf, inv_s)
    nxt_same = torch.cat([ridx[1:] == ridx[:-1],
                          torch.zeros_like(ridx[:1], dtype=torch.bool)])
    shifted = torch.cat([cdf[1:], cdf[-1:]])
    last_val = torch.ones_like(cdf) if append_cdf_1 else cdf
    cdf_next = torch.where(nxt_same, shifted, last_val)
    return torch.clamp((cdf - cdf_next) / (cdf + 1e-5), min=0.0)
