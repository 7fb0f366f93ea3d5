"""NeuS importance upsampling (port of
nr3d_lib_tpu/graphics/neus_ray_query.py `_upsample_rounds`).

Dense [R, S] slabs: invalid slots carry t=far and sdf=+BIG so their alphas
vanish; merging an upsample round into the slab is a stable per-ray sort
with the validity and cached SDF values carried along as payloads.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from nr3d_lib_tpu_torch.graphics.nerf import ray_alpha_to_vw
from nr3d_lib_tpu_torch.graphics.neus import neus_ray_sdf_to_alpha
from nr3d_lib_tpu_torch.graphics.raysample import batch_sample_pdf

__all__ = ["_upsample_rounds"]

_BIG_SDF = 1e4


def _sort_tvs(t, valid, sdf, far):
    """Stable sort of the slab by t (invalid last), payloads following."""
    key = torch.where(valid, t, torch.full_like(t, float("inf")))
    key_s, order = torch.sort(key, dim=-1, stable=True)
    v_s = valid.gather(-1, order)
    sdf_s = sdf.gather(-1, order)
    return torch.where(v_s, key_s, far[:, None].expand_as(key_s)), v_s, sdf_s


def _upsample_rounds(sdf_fn, o_n: torch.Tensor, d_n: torch.Tensor,
                     t: torch.Tensor, valid: torch.Tensor, far: torch.Tensor,
                     inv_s_base: float, upsample_inv_s_factors: Sequence[float],
                     n_importance: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative NeuS importance sampling. Each round: alphas at growing
    sharpness → CDF sample → merge-sort into the slab. SDF values are cached
    across rounds: only each round's new samples hit the network. Returns
    (t [R, S + rounds·n_importance] sorted, valid); t carries no gradient."""
    r = t.shape[0]

    def eval_sdf(t_):
        x = o_n[:, None, :] + d_n[:, None, :] * t_[..., None]
        return sdf_fn(x.reshape(-1, 3)).reshape(r, t_.shape[1])

    sdf = eval_sdf(t)                       # the one full-slab evaluation
    for factor in upsample_inv_s_factors:
        t, valid, sdf = _sort_tvs(t, valid, sdf, far)
        sdf_m = torch.where(valid, sdf, torch.full_like(sdf, _BIG_SDF))
        alpha = neus_ray_sdf_to_alpha(sdf_m, inv_s_base * factor,
                                      append_cdf_1=False)          # [R,S-1]
        w = ray_alpha_to_vw(alpha)
        t_new = batch_sample_pdf(t, w, n_importance)               # [R,n_imp]
        sdf_new = eval_sdf(t_new)           # only the new samples
        t = torch.cat([t, t_new], -1)
        valid = torch.cat([valid, torch.ones_like(t_new, dtype=torch.bool)],
                          -1)
        sdf = torch.cat([sdf, sdf_new], -1)
    t, valid, _ = _sort_tvs(t, valid, sdf, far)
    return t.detach(), valid
