"""GEM occupancy losses, and the gated CLIP loss (port of
nr3d_lib_tpu/models/loss/gem.py)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["gem_density_reg", "gem_opacity_loss", "clip_loss"]


def gem_density_reg(sigma: torch.Tensor, lamb: float = 0.05) -> torch.Tensor:
    """Cauchy-style density sparsity: mean log(1 + σ²/λ)."""
    return torch.mean(torch.log1p(sigma ** 2 / lamb))


def gem_opacity_loss(acc: torch.Tensor, mask_gt: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """Binary-entropy opacity loss on acc clipped to [eps, 1 − eps]:
    without a mask it pushes each ray's opacity to 0 or 1, with one it is
    the BCE against the mask."""
    a = torch.clamp(acc, eps, 1.0 - eps)
    if mask_gt is None:
        return torch.mean(-(a * torch.log(a) + (1 - a) * torch.log(1 - a)))
    m = mask_gt.to(a.dtype)
    return torch.mean(-(m * torch.log(a) + (1 - m) * torch.log(1 - a)))


def clip_loss(*args, **kwargs):
    """Raises ImportError, as the JAX package's does: the CLIP loss needs
    pretrained CLIP weights, which neither package ships."""
    raise ImportError(
        "the CLIP loss needs pretrained CLIP weights, which are not "
        "available; nr3d_lib's models/loss/clip.py is the reference")
