"""LoTD parameter helpers: per-level slicing, the grower's resampling of a
level, and the gradient-spike guard (port of nr3d_lib_tpu/models/
grid_encodings/lotd/lotd_helpers.py)."""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from nr3d_lib_tpu_torch.ops.lotd import LoDMeta, LoDType, level_param_slice

__all__ = ["level_param_shape", "get_level_param", "set_level_param",
           "param_interpolate", "GradGuard"]


def level_param_shape(meta: LoDMeta, level: int) -> Tuple[int, ...]:
    """Natural (unflattened) shape of one level's parameters."""
    t = meta.level_types[level]
    res = meta.level_res[level]
    f = meta.level_n_feats[level]
    if t == LoDType.Dense:
        return tuple(res) + (f,)
    return (meta.level_sizes[level], f)


def get_level_param(params: torch.Tensor, meta: LoDMeta, level: int,
                    batched: bool = False) -> torch.Tensor:
    """One level's parameters in their natural shape (a view); `batched`:
    params [B, n_params] → [B, *shape]."""
    sl = level_param_slice(meta, level)
    if batched:
        return params[:, sl].reshape((params.shape[0],)
                                     + level_param_shape(meta, level))
    return params[sl].reshape(level_param_shape(meta, level))


def set_level_param(params: torch.Tensor, meta: LoDMeta, level: int,
                    value: torch.Tensor) -> torch.Tensor:
    """A copy of the flat params with one level replaced by `value`."""
    sl = level_param_slice(meta, level)
    out = params.clone()
    out[sl] = value.reshape(-1).to(out.dtype)
    return out


def _linspace(stop: int, num: int, device) -> torch.Tensor:
    """`jnp.linspace(0, stop, num)` by its formula: start·(1 − s) +
    stop·s with s = i / (num − 1), and the endpoint exactly `stop`."""
    if num == 1:
        return torch.zeros(1, device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / \
        float(num - 1)
    return torch.cat([0.0 * (1.0 - step) + float(stop) * step,
                      torch.full((1,), float(stop), device=device)])


def param_interpolate(level_param: torch.Tensor, new_res: Sequence[int]
                      ) -> torch.Tensor:
    """Trilinearly up- or down-sample a Dense level's vertex grid (the
    grower's "rescale" path): [rx, ry, rz, F] → [*new_res, F]."""
    old = level_param
    rx, ry, rz, _ = old.shape
    dev = old.device
    grid = torch.stack(torch.meshgrid(
        _linspace(rx - 1, new_res[0], dev), _linspace(ry - 1, new_res[1], dev),
        _linspace(rz - 1, new_res[2], dev), indexing="ij"), -1)
    c0 = torch.floor(grid).to(torch.int64)
    c0 = torch.minimum(c0, torch.tensor([rx - 2, ry - 2, rz - 2],
                                        device=dev))
    w = (grid - c0).to(old.dtype)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wt = ((w[..., 0] if dx else 1 - w[..., 0])
                      * (w[..., 1] if dy else 1 - w[..., 1])
                      * (w[..., 2] if dz else 1 - w[..., 2]))
                out = out + wt[..., None] * old[c0[..., 0] + dx,
                                                c0[..., 1] + dy,
                                                c0[..., 2] + dz]
    return out


class GradGuard:
    """Gradient-spike guard: scales the gradients down when their global
    norm exceeds `ema_factor` × its running EMA, which protects
    second-order LoTD training from rare spikes. Called with the
    parameters after the backward; it acts on their `.grad` in place."""

    def __init__(self, ema_decay: float = 0.99, ema_factor: float = 10.0):
        self.ema_decay = ema_decay
        self.ema_factor = ema_factor
        self.ema_norm: Optional[float] = None

    def __call__(self, params: Iterable[torch.Tensor]
                 ) -> Tuple[List[torch.Tensor], bool]:
        """→ (the `.grad` tensors, whether they were scaled)."""
        from nr3d_lib_tpu_torch.models.utils import calc_grad_norm

        params = [p for p in params if p.grad is not None]
        grads = [p.grad for p in params]
        norm = float(calc_grad_norm(params))
        if self.ema_norm is None:
            self.ema_norm = norm
            return grads, False
        limit = self.ema_factor * self.ema_norm
        clipped = norm > limit
        if clipped:
            scale = limit / max(norm, 1e-12)
            with torch.no_grad():
                for g in grads:
                    g.mul_(scale)
            norm = limit
        self.ema_norm = self.ema_decay * self.ema_norm \
            + (1 - self.ema_decay) * norm
        return grads, clipped
