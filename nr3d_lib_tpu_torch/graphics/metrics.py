"""Image metrics: PSNR, SSIM (re-exported from `models/loss/ssim.py`),
LPIPS through the `lpips` package where it is installed, and the sRGB
transfer pair (port of nr3d_lib_tpu/graphics/metrics.py)."""

from __future__ import annotations

from typing import Optional

import torch

from nr3d_lib_tpu_torch.models.loss.ssim import ssim  # noqa: F401

__all__ = ["psnr", "ssim", "lpips", "linear_to_srgb", "srgb_to_linear"]


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """10·log10(max² / MSE) in float32; `mask` [...] (a prefix of pred's
    shape) weights the squared errors, as in JAX."""
    pred = torch.as_tensor(pred).to(torch.float32)
    gt = torch.as_tensor(gt).to(pred.device, torch.float32)
    if mask is not None:
        m = mask.to(pred.device, torch.float32).reshape(
            tuple(mask.shape) + (1,) * (pred.ndim - mask.ndim))
        m = torch.broadcast_to(m, pred.shape)
        mse = torch.sum((pred - gt) ** 2 * m) / torch.clamp(torch.sum(m),
                                                            min=1.0)
    else:
        mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def lpips(pred, gt, net: str = "vgg") -> float:
    """Perceptual distance of two [H, W, 3] images in [0, 1] by the
    `lpips` package, which needs its pretrained weights; raises
    ImportError, as JAX's does, where the package does not import."""
    try:
        import lpips as _lpips_mod
    except ImportError as e:
        raise ImportError(
            "LPIPS needs the `lpips` torch package with pretrained weights "
            "(unavailable in zero-egress environments)") from e
    model = _lpips_mod.LPIPS(net=net)
    a = torch.as_tensor(pred, dtype=torch.float32).cpu()
    b = torch.as_tensor(gt, dtype=torch.float32).cpu()
    with torch.no_grad():
        return float(model(a.permute(2, 0, 1)[None] * 2 - 1,
                           b.permute(2, 0, 1)[None] * 2 - 1))


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=1e-8), 1 / 2.4)
                       - 0.055)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))
