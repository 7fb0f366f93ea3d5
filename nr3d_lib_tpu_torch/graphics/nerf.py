"""Volume-render weights (port of nr3d_lib_tpu/graphics/nerf.py
`ray_alpha_to_vw`)."""

from __future__ import annotations

import torch

from nr3d_lib_tpu_torch.graphics import _scan

__all__ = ["ray_alpha_to_vw"]


def ray_alpha_to_vw(alpha: torch.Tensor) -> torch.Tensor:
    """[..., S] α → visibility weights via exclusive transmittance."""
    one_m = torch.clamp(1.0 - alpha, 0.0, 1.0)
    trans = _scan.cumprod(torch.cat(
        [torch.ones_like(one_m[..., :1]), one_m[..., :-1]], -1), -1)
    return alpha * trans
