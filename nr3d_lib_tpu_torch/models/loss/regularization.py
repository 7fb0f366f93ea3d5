"""Geometry and volume regularizers (port of
nr3d_lib_tpu/models/loss/regularization.py: `eikonal_loss`,
`normal_smoothness_loss`, `entropy_regularization`, `distortion_loss`)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["eikonal_loss", "normal_smoothness_loss", "entropy_regularization",
           "distortion_loss"]


def _masked_mean(loss: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is not None:
        m = mask.to(loss.dtype)
        return torch.sum(loss * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(loss)


def eikonal_loss(nablas: torch.Tensor, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """E[(‖∇sdf‖−1)²] over the rows of nablas [..., 3]; with `mask`, the
    mean over the masked rows (a sum over at least one)."""
    return _masked_mean(
        (torch.linalg.vector_norm(nablas, dim=-1) - 1.0) ** 2, mask)


def normal_smoothness_loss(nablas: torch.Tensor,
                           nablas_perturbed: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """‖n(x) − n(x+ε)‖² of the normalized normals, mean (masked as
    `eikonal_loss`)."""
    def unit(n):
        return n / torch.clamp(torch.linalg.vector_norm(
            n, dim=-1, keepdim=True), min=1e-8)
    return _masked_mean(
        torch.sum((unit(nablas) - unit(nablas_perturbed)) ** 2, -1), mask)


def entropy_regularization(vw: torch.Tensor, eps: float = 1e-6
                           ) -> torch.Tensor:
    """The entropy of each ray's normalized weights vw [..., S], mean over
    the rays: pushes the weights to be peaky."""
    p = vw / torch.clamp(torch.sum(vw, -1, keepdim=True), min=eps)
    return -torch.mean(torch.sum(p * torch.log(p + eps), -1))


def distortion_loss(t: torch.Tensor, vw: torch.Tensor) -> torch.Tensor:
    """mip-NeRF-360 distortion over dense t, vw [R, S]: Σᵢⱼ wᵢwⱼ|tᵢ−tⱼ| +
    ⅓Σᵢwᵢ²Δᵢ (Δ the step to the next sample, 0 at the last), mean over
    the rays. Builds [R, S, S]."""
    cross = torch.abs(t[..., :, None] - t[..., None, :])
    w_outer = vw[..., :, None] * vw[..., None, :]
    loss_cross = torch.sum(w_outer * cross, (-1, -2))
    dt = torch.cat([t[..., 1:] - t[..., :-1], torch.zeros_like(t[..., :1])],
                   -1)
    loss_self = torch.sum(vw ** 2 * dt, -1) / 3.0
    return torch.mean(loss_cross + loss_self)
