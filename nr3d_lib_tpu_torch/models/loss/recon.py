"""Reconstruction losses (port of nr3d_lib_tpu/models/loss/recon.py)."""

from __future__ import annotations

import functools
from typing import Optional

import torch

__all__ = ["reduce", "mse_loss", "l1_loss", "huber_loss", "mape_loss",
           "smape_loss", "relative_l2_loss", "get_recon_loss"]


def reduce(loss: torch.Tensor, mask: Optional[torch.Tensor] = None,
           reduction: str = "mean") -> torch.Tensor:
    """Masked reduction: `mask` (broadcast over the trailing dims of
    `loss`) zeroes entries, and "mean" then divides by the mask's sum
    (at least 1); "sum" sums; anything else returns the elementwise
    loss."""
    if mask is not None:
        mask = mask.to(loss.dtype).reshape(
            mask.shape + (1,) * (loss.ndim - mask.ndim)).expand(loss.shape)
        loss = loss * mask
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(torch.sum(mask), min=1.0)
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def mse_loss(pred, gt, mask=None, reduction="mean"):
    return reduce((pred - gt) ** 2, mask, reduction)


def l1_loss(pred, gt, mask=None, reduction="mean"):
    return reduce(torch.abs(pred - gt), mask, reduction)


def huber_loss(pred, gt, delta: float = 0.1, mask=None, reduction="mean"):
    err = pred - gt
    abs_e = torch.abs(err)
    quad = 0.5 * err ** 2
    lin = delta * (abs_e - 0.5 * delta)
    return reduce(torch.where(abs_e <= delta, quad, lin), mask, reduction)


def mape_loss(pred, gt, eps: float = 1e-2, mask=None, reduction="mean"):
    """Mean absolute percentage error."""
    return reduce(torch.abs(pred - gt) / (torch.abs(gt) + eps), mask,
                  reduction)


def smape_loss(pred, gt, eps: float = 1e-2, mask=None, reduction="mean"):
    """Symmetric mean absolute percentage error."""
    denom = 0.5 * (torch.abs(pred) + torch.abs(gt)) + eps
    return reduce(torch.abs(pred - gt) / denom, mask, reduction)


def relative_l2_loss(pred, gt, eps: float = 1e-2, mask=None,
                     reduction="mean"):
    """NGP's relative L2: the squared error over pred² + eps, pred² taken
    without a gradient."""
    return reduce((pred - gt) ** 2 / (pred.detach() ** 2 + eps), mask,
                  reduction)


def get_recon_loss(type: str = "mse", **kwargs):
    """Loss by name (mse/l2, l1, huber/smooth_l1, mape, smape,
    relative_l2), its keyword arguments bound; an unknown name raises
    KeyError."""
    table = {"mse": mse_loss, "l2": mse_loss, "l1": l1_loss,
             "huber": huber_loss, "smooth_l1": huber_loss,
             "mape": mape_loss, "smape": smape_loss,
             "relative_l2": relative_l2_loss}
    fn = table[type.lower()]
    return functools.partial(fn, **kwargs) if kwargs else fn
