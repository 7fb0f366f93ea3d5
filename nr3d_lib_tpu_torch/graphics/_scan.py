"""Cumulative sums and products accumulated in float64.

The CPU computes a scan element after element; the CUDA scan associates
the terms in another order. Rounding a float64 accumulation back to the
input's dtype gives (nearly always) the same float32 prefixes on both
routes, so the discrete choices downstream of a scan (the inverse-CDF
bracket, the early-stop test) agree between them (PERF.md has the
measured effect on the CUDA-vs-CPU agreement of the render).
"""

from __future__ import annotations

import torch

from nr3d_lib_tpu_torch.profile import count_backward_sync

__all__ = ["cumsum", "cumprod"]


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x.to(torch.float64), dim).to(x.dtype)


def cumprod(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Under autograd its backward tests the factors for a zero on the
    host, one wait for the device (`count_backward_sync`; a factor that
    is exactly 0 takes a slower path with two more)."""
    out = torch.cumprod(x.to(torch.float64), dim)
    if out.requires_grad:
        count_backward_sync(out)
    return out.to(x.dtype)
