"""NeuS math: logistic-CDF SDF → alpha and visibility weights, dense and
packed (port of nr3d_lib_tpu/graphics/neus.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nr3d_lib_tpu_torch.graphics.nerf import ray_alpha_to_vw
from nr3d_lib_tpu_torch.graphics.pack_ops import packed_alpha_to_vw

__all__ = ["neus_cdf", "neus_ray_sdf_to_alpha", "neus_ray_sdf_to_vw",
           "neus_packed_sdf_to_alpha", "neus_packed_sdf_to_vw",
           "neus_estimate_sdf_nablas_to_alpha"]


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


def neus_ray_sdf_to_vw(sdf: torch.Tensor, inv_s,
                       append_cdf_1: bool = False) -> torch.Tensor:
    return ray_alpha_to_vw(neus_ray_sdf_to_alpha(sdf, inv_s, append_cdf_1))


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


def neus_packed_sdf_to_vw(sdf: torch.Tensor, inv_s, ridx: torch.Tensor,
                          append_cdf_1: bool = True) -> torch.Tensor:
    return packed_alpha_to_vw(
        neus_packed_sdf_to_alpha(sdf, inv_s, ridx, append_cdf_1), ridx)


def neus_estimate_sdf_nablas_to_alpha(sdf: torch.Tensor,
                                      deltas: torch.Tensor,
                                      nablas: torch.Tensor,
                                      dirs: torch.Tensor, inv_s,
                                      ratio: float = 1.0,
                                      delta_max: float = 1e10
                                      ) -> torch.Tensor:
    """The original NeuS estimator: the section's end sdfs estimated from
    its midpoint sdf and the slope cos θ = ∇·d (front-facing only,
    annealed by `ratio`), α from their cdf ratio, clipped to [0, 1]."""
    deltas = torch.clamp(deltas, max=delta_max)
    cos = torch.sum(nablas * dirs, -1)
    cos = -(F.relu(-cos * 0.5 + 0.5) * (1.0 - ratio) + F.relu(-cos) * ratio)
    est_prev = sdf - cos * deltas * 0.5
    est_next = sdf + cos * deltas * 0.5
    cdf_prev = neus_cdf(est_prev, inv_s)
    cdf_next = neus_cdf(est_next, inv_s)
    return torch.clamp((cdf_prev - cdf_next) / (cdf_prev + 1e-5), 0.0, 1.0)
