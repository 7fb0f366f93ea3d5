"""Step and inverse-CDF samplers (port of nr3d_lib_tpu/graphics/
raysample.py), and the seam through which the perturbed samplers get
their uniforms.

`jax.random` cannot be reproduced in torch, so the samplers take their
uniforms `u` as an argument (None: the bin midpoints or fixed quantiles),
and the ray query draws them through a `Draw`
callable, `draw(shape, lo, hi)` → U[lo, hi) on the query's device.
`uniform_draw(generator)` is the default; a test hands in a callable that
returns the JAX package's draws in its split order instead.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from nr3d_lib_tpu_torch.graphics import _scan
from nr3d_lib_tpu_torch.graphics.pack_ops import packed_invert_cdf

__all__ = ["Draw", "uniform_draw", "batch_sample_step_linear",
           "batch_sample_step_wrt_depth", "batch_sample_step_wrt_sqrt_depth",
           "batch_sample_cdf", "batch_sample_pdf", "packed_sample_cdf",
           "CDF_EPS", "linspace_f32"]

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


def linspace_f32(start: float, stop: float, n: int,
                 device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, n)` by its own formula in float32 steps:
    step_i = i / (n − 1), start·(1 − step_i) + stop·step_i, the last
    entry `stop` exactly (`torch.linspace` rounds differently)."""
    if n == 1:
        return torch.tensor([start], dtype=torch.float32, device=device)
    div = n - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / \
        float(div)
    a = torch.tensor(start, dtype=torch.float32, device=device)
    b = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([a * (1.0 - step) + b * step, b[None]])


def _bin_samples(edges: torch.Tensor, u: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edges [R, S+1] → (t, dt): the midpoints, or with `u` [R, S] a
    stratified jitter inside each bin."""
    lo, hi = edges[..., :-1], edges[..., 1:]
    t = 0.5 * (lo + hi) if u is None else lo + (hi - lo) * u
    return t, hi - lo


def batch_sample_step_wrt_depth(near: torch.Tensor, far: torch.Tensor,
                                n_samples: int, dt_gamma: float = 0.01,
                                u: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-proportional steps (dt ∝ t): log-spaced edges from
    max(near, 1e-6) to far → (t [R,S], dt [R,S]); `dt_gamma` is taken
    and unused, as in the JAX version (the log spacing sets the ratio).
    The logs and exps are taken in float64 and the edges rounded to the
    input's dtype: the card's float32 exp differs from the CPU's by an
    ulp or two, which dt, a difference of neighbouring edges, would
    carry as a relative error of ~1e-5."""
    near_c = torch.clamp(near, min=1e-6)
    far_c = torch.maximum(far, near_c + 1e-6)
    s = linspace_f32(0.0, 1.0, n_samples + 1, near.device).to(torch.float64)
    log_near = torch.log(near_c.to(torch.float64))
    log_far = torch.log(far_c.to(torch.float64))
    edges = torch.exp(log_near[..., None] + (log_far - log_near)[..., None]
                      * s).to(near.dtype)
    return _bin_samples(edges, u)


def batch_sample_step_wrt_sqrt_depth(near: torch.Tensor, far: torch.Tensor,
                                     n_samples: int,
                                     u: Optional[torch.Tensor] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Samples uniform in √depth → (t [R,S], dt [R,S]); the edges in
    float64, rounded to the input's dtype (as in
    `batch_sample_step_wrt_depth`)."""
    sq0 = torch.sqrt(torch.clamp(near, min=0.0).to(torch.float64))
    sq1 = torch.sqrt(torch.clamp(far, min=0.0).to(torch.float64))
    s = linspace_f32(0.0, 1.0, n_samples + 1, near.device).to(torch.float64)
    root = sq0[..., None] + (sq1 - sq0)[..., None] * s
    return _bin_samples((root * root).to(near.dtype), u)


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


def packed_sample_cdf(bins: torch.Tensor, cdfs: torch.Tensor,
                      ridx: torch.Tensor, n_packs: int, n_per_pack: int,
                      u: Optional[torch.Tensor] = None, eps: float = CDF_EPS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed inverse-CDF sampling, `n_per_pack` samples a pack from its
    packed (bins, cdfs) → (t [n_packs·n_per_pack], sample ridx). `u`
    [n_packs·n_per_pack] the quantiles (perturbed: U[eps, 1−eps)), None →
    (i+½)/n in every pack."""
    if u is None:
        u = linspace_f32(0.5 / n_per_pack, 1.0 - 0.5 / n_per_pack,
                         n_per_pack, bins.device).repeat(n_packs)
    u_ridx = torch.arange(n_packs, dtype=torch.int32,
                          device=bins.device).repeat_interleave(n_per_pack)
    return packed_invert_cdf(bins, cdfs, ridx, u, u_ridx, n_packs,
                             eps=eps), u_ridx
