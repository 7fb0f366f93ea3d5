"""Volume-render weights and compositing (port of
nr3d_lib_tpu/graphics/nerf.py; the packed forms are `pack_ops`')."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nr3d_lib_tpu_torch.graphics import _scan
from nr3d_lib_tpu_torch.graphics.pack_ops import (packed_alpha_to_vw,
                                                  packed_tau_to_vw)

__all__ = ["tau_to_alpha", "ray_alpha_to_vw", "ray_tau_to_vw",
           "packed_alpha_to_vw", "packed_tau_to_vw", "ray_composite"]


def tau_to_alpha(tau: torch.Tensor) -> torch.Tensor:
    """Optical depth per interval → opacity."""
    return 1.0 - torch.exp(-tau)


def ray_alpha_to_vw(alpha: torch.Tensor) -> torch.Tensor:
    """[..., S] α → visibility weights via exclusive transmittance."""
    one_m = torch.clamp(1.0 - alpha, 0.0, 1.0)
    trans = _scan.cumprod(torch.cat(
        [torch.ones_like(one_m[..., :1]), one_m[..., :-1]], -1), -1)
    return alpha * trans


def ray_tau_to_vw(tau: torch.Tensor) -> torch.Tensor:
    """[..., S] optical depth → visibility weights (1 − e^−τ_i) ·
    e^−Σ_{j<i} τ_j."""
    t_excl = _scan.cumsum(tau, -1) - tau
    return tau_to_alpha(tau) * torch.exp(-t_excl)


def ray_composite(vw: torch.Tensor, values: torch.Tensor,
                  depth_t: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Composite per-sample values [R, S, C] with weights vw [R, S] →
    {rgb [R, C], mask_volume [R]} and, with depth_t [R, S], the
    weight-normalized depth_volume [R]."""
    out = {"rgb": torch.sum(vw[..., None] * values, -2),
           "mask_volume": torch.sum(vw, -1)}
    if depth_t is not None:
        acc = torch.clamp(out["mask_volume"], min=1e-10)
        out["depth_volume"] = torch.sum(vw * depth_t, -1) / acc
    return out
