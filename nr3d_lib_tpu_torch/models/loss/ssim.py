"""SSIM with a Gaussian window (port of nr3d_lib_tpu/models/loss/
ssim.py): differentiable, and the SSIM metric too."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ssim"]


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d(img: torch.Tensor, kern1d: np.ndarray) -> torch.Tensor:
    """Separable filter over the two leading axes of img [H, W, C]: along
    H, then along W, each with edge padding, the taps summed in order
    (not a zero-padded convolution)."""
    pad = len(kern1d) // 2
    k = [float(v) for v in kern1d]
    h, w = img.shape[0], img.shape[1]
    img_p = torch.cat([img[:1].expand(pad, -1, -1), img,
                       img[-1:].expand(pad, -1, -1)], 0)
    out = torch.zeros_like(img)
    for i, ki in enumerate(k):
        out = out + ki * img_p[i:i + h]
    img_p = torch.cat([out[:, :1].expand(-1, pad, -1), out,
                       out[:, -1:].expand(-1, pad, -1)], 1)
    out2 = torch.zeros_like(img)
    for i, ki in enumerate(k):
        out2 = out2 + ki * img_p[:, i:i + w]
    return out2


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         return_map: bool = False) -> torch.Tensor:
    """img [H, W, C] (or [H, W]) in [0, max_val] → the mean SSIM (or the
    map [H, W, C]), in float32."""
    img0 = torch.as_tensor(img0).to(torch.float32)
    img1 = torch.as_tensor(img1).to(torch.float32)
    if img0.ndim == 2:
        img0, img1 = img0[..., None], img1[..., None]
    kern = _gaussian_kernel(filter_size, filter_sigma)
    mu0 = _filter2d(img0, kern)
    mu1 = _filter2d(img1, kern)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = _filter2d(img0 * img0, kern) - mu00
    s11 = _filter2d(img1 * img1, kern) - mu11
    s01 = _filter2d(img0 * img1, kern) - mu01
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu01 + c1) * (2 * s01 + c2)) / \
        ((mu00 + mu11 + c1) * (s00 + s11 + c2))
    return ssim_map if return_map else torch.mean(ssim_map)
