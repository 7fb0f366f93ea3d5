"""Common densities and helpers (port of nr3d_lib_tpu/maths/common.py):
the NeuS logistic density and its CDF, and a clamped normalization."""

from __future__ import annotations

import torch

__all__ = ["logistic_density", "logistic_cdf", "normalize"]


def logistic_density(x, inv_s):
    """s·e^{-sx} / (1+e^{-sx})², the NeuS φ_s."""
    return inv_s * torch.sigmoid(-inv_s * x) * torch.sigmoid(inv_s * x)


def logistic_cdf(x, inv_s):
    return torch.sigmoid(inv_s * x)


def normalize(v: torch.Tensor, axis: int = -1, eps: float = 1e-8
              ) -> torch.Tensor:
    """v / max(‖v‖, eps) along `axis`."""
    n = torch.linalg.norm(v, dim=axis, keepdim=True)
    return v / torch.maximum(n, torch.full_like(n, eps))
