"""Step and inverse-CDF samplers (port of nr3d_lib_tpu/graphics/
raysample.py `batch_sample_step_linear`, `batch_sample_cdf`,
`batch_sample_pdf`), and the seam through which the perturbed samplers get
their uniforms.

`jax.random` cannot be reproduced in torch, so the samplers take their
uniforms `u` as an argument, and the ray query draws them through a `Draw`
callable, `draw(shape, lo, hi)` → U[lo, hi) on the query's device.
`uniform_draw(generator)` is the default; a test hands in a callable that
returns the JAX package's draws in its split order instead.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from nr3d_lib_tpu_torch.graphics import _scan

__all__ = ["Draw", "uniform_draw", "batch_sample_step_linear",
           "batch_sample_cdf", "batch_sample_pdf", "CDF_EPS"]

Draw = Callable[[Tuple[int, ...], float, float], torch.Tensor]
CDF_EPS = 1e-8        # the perturbed CDF sampler draws u in [eps, 1 − eps)


def uniform_draw(generator: torch.Generator) -> Draw:
    """U[lo, hi) from `generator`, on the generator's device."""
    def draw(shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=generator.device)
        return lo + (hi - lo) * u
    return draw


def batch_sample_step_linear(near: torch.Tensor, far: torch.Tensor,
                             n_samples: int, u: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform-in-depth samples → (t [R,S], dt [R,S]): the bin midpoints,
    or with `u` [R,S] in [0,1) a stratified jitter inside each bin."""
    s = torch.linspace(0.0, 1.0, n_samples + 1, dtype=near.dtype,
                       device=near.device)
    edges = near[..., None] + (far - near)[..., None] * s
    lo, hi = edges[..., :-1], edges[..., 1:]
    t = 0.5 * (lo + hi) if u is None else lo + (hi - lo) * u
    return t, hi - lo


def batch_sample_cdf(bins: torch.Tensor, cdfs: torch.Tensor, n_samples: int,
                     u: Optional[torch.Tensor] = None, eps: float = CDF_EPS
                     ) -> torch.Tensor:
    """Inverse-transform sampling from per-ray CDFs. bins: [R, B] sorted
    positions; cdfs: [R, B] monotone; `u` [R, n_samples] the quantiles
    (perturbed: U[eps, 1−eps)), None → the fixed quantiles (i+½)/n.
    Returns t [R, n_samples]. The bracket count of `cdf <= u` is
    `searchsorted(right=True)` (the CDF is monotone)."""
    r, nb = bins.shape
    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=bins.dtype, device=bins.device)
        u = u.expand(r, n_samples)
    u = u.contiguous()
    cnt = torch.searchsorted(cdfs.contiguous(), u, right=True)
    hi = cnt.clamp(1, nb - 1)
    lo = hi - 1
    c0, c1 = cdfs.gather(-1, lo), cdfs.gather(-1, hi)
    b0, b1 = bins.gather(-1, lo), bins.gather(-1, hi)
    denom = torch.where(c1 - c0 < eps, torch.ones_like(c0), c1 - c0)
    frac = torch.clamp((u - c0) / denom, 0.0, 1.0)
    return b0 + frac * (b1 - b0)


def batch_sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
                     n_samples: int, u: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """Hierarchical sampling from per-bin weights.
    bins: [R, B+1] edges; weights: [R, B] ≥ 0; `u` as in
    `batch_sample_cdf`."""
    w = weights + eps
    pdf = w / torch.sum(w, -1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), _scan.cumsum(pdf, -1)],
                    -1)
    return batch_sample_cdf(bins, cdf, n_samples, u)
