"""Training utilities (port of part of nr3d_lib_tpu/models/utils.py:
`calc_grad_norm`; the schedulers, optimizers and `batchify_query` wait in
ROADMAP.md A14), and the global-norm clip of the JAX package's trainers,
`optax.clip_by_global_norm`, on torch gradients.
"""

from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["calc_grad_norm", "clip_by_global_norm_"]


def calc_grad_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of the parameters' gradients (those without a
    gradient skipped), a 0-d tensor on their device."""
    grads = [p.grad for p in params if p.grad is not None]
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for g in grads))


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Clip the gradients in place as `optax.clip_by_global_norm` does:
    unchanged while their global norm is below `max_norm`, else each
    becomes g / norm · max_norm (`torch.nn.utils.clip_grad_norm_` scales
    by max_norm / (norm + 1e-6) instead). Decided on the device, with no
    host sync. Returns the norm before clipping."""
    params = [p for p in params if p.grad is not None]
    norm = calc_grad_norm(params)
    for p in params:
        p.grad.copy_(torch.where(norm < max_norm, p.grad,
                                 p.grad / norm * max_norm))
    return norm
