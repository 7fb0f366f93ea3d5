"""Numerically guarded losses with custom gradients (port of
nr3d_lib_tpu/models/loss/safe.py: the JAX `custom_vjp`s become
`torch.autograd.Function`s with the same backwards)."""

from __future__ import annotations

import torch

__all__ = ["safe_binary_cross_entropy", "clipped_mse"]

_P_EPS = 1e-6


class _SafeBCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, gt, clip_grad):
        p = torch.clamp(pred, _P_EPS, 1.0 - _P_EPS)
        ctx.save_for_backward(p, gt)
        ctx.clip_grad = clip_grad
        return -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))

    @staticmethod
    def backward(ctx, g):
        p, gt = ctx.saved_tensors
        # d/dp = (p − y) / (p (1 − p)) at the clipped p, clipped to
        # ±clip_grad; d/dy = log(1 − p) − log p
        gp = torch.clamp((p - gt) / (p * (1.0 - p)), -ctx.clip_grad,
                         ctx.clip_grad)
        return (g * gp, g * (torch.log(1.0 - p) - torch.log(p)), None)


def safe_binary_cross_entropy(pred: torch.Tensor, gt: torch.Tensor,
                              clip_grad: float = 100.0) -> torch.Tensor:
    """Elementwise BCE of pred clipped to [1e-6, 1 − 1e-6]; its gradient in
    pred is (p − y)/(p(1 − p)) clipped to ±clip_grad (nonzero past the
    clip, as in JAX), in gt log(1 − p) − log p."""
    pred, gt = torch.broadcast_tensors(pred, torch.as_tensor(
        gt, dtype=pred.dtype, device=pred.device))
    return _SafeBCE.apply(pred, gt, float(clip_grad))


class _ClippedMSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, gt, clip_err):
        ctx.save_for_backward(pred, gt)
        ctx.clip_err = clip_err
        return (pred - gt) ** 2

    @staticmethod
    def backward(ctx, g):
        pred, gt = ctx.saved_tensors
        err = torch.clamp(pred - gt, -ctx.clip_err, ctx.clip_err)
        return g * 2.0 * err, -g * 2.0 * err, None


def clipped_mse(pred: torch.Tensor, gt: torch.Tensor,
                clip_err: float = 1.0) -> torch.Tensor:
    """Elementwise (pred − gt)², whose gradient is 2·clip(pred − gt,
    ±clip_err) (−that in gt)."""
    pred, gt = torch.broadcast_tensors(pred, torch.as_tensor(
        gt, dtype=pred.dtype, device=pred.device))
    return _ClippedMSE.apply(pred, gt, float(clip_err))
