"""Geometry regularizers (port of nr3d_lib_tpu/models/loss/regularization.py
`eikonal_loss`, the train step's eikonal term)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["eikonal_loss"]


def eikonal_loss(nablas: torch.Tensor, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """E[(‖∇sdf‖−1)²] over the rows of nablas [..., 3]; with `mask`, the
    mean over the masked rows (a sum over at least one)."""
    loss = (torch.linalg.vector_norm(nablas, dim=-1) - 1.0) ** 2
    if mask is not None:
        m = mask.to(loss.dtype)
        return torch.sum(loss * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(loss)
