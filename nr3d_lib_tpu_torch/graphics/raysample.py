"""Inverse-CDF importance sampling (port of
nr3d_lib_tpu/graphics/raysample.py `batch_sample_cdf`,
`batch_sample_pdf`, unperturbed)."""

from __future__ import annotations

import torch

from nr3d_lib_tpu_torch.graphics import _scan

__all__ = ["batch_sample_cdf", "batch_sample_pdf"]


def batch_sample_cdf(bins: torch.Tensor, cdfs: torch.Tensor, n_samples: int,
                     eps: float = 1e-8) -> torch.Tensor:
    """Inverse-transform sampling from per-ray CDFs at the fixed quantiles
    u = (i+½)/n. bins: [R, B] sorted positions; cdfs: [R, B] monotone.
    Returns t [R, n_samples]. The bracket count of `cdf <= u` is
    `searchsorted(right=True)` (the CDF is monotone)."""
    r, nb = bins.shape
    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                       dtype=bins.dtype, device=bins.device)
    u = u.expand(r, n_samples).contiguous()
    cnt = torch.searchsorted(cdfs.contiguous(), u, right=True)
    hi = cnt.clamp(1, nb - 1)
    lo = hi - 1
    c0, c1 = cdfs.gather(-1, lo), cdfs.gather(-1, hi)
    b0, b1 = bins.gather(-1, lo), bins.gather(-1, hi)
    denom = torch.where(c1 - c0 < eps, torch.ones_like(c0), c1 - c0)
    frac = torch.clamp((u - c0) / denom, 0.0, 1.0)
    return b0 + frac * (b1 - b0)


def batch_sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
                     n_samples: int, eps: float = 1e-5) -> torch.Tensor:
    """Hierarchical sampling from per-bin weights.
    bins: [R, B+1] edges; weights: [R, B] ≥ 0."""
    w = weights + eps
    pdf = w / torch.sum(w, -1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), _scan.cumsum(pdf, -1)],
                    -1)
    return batch_sample_cdf(bins, cdf, n_samples)
