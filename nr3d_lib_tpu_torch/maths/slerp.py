"""Quaternion slerp (port of nr3d_lib_tpu/maths/slerp.py)."""

from __future__ import annotations

import torch

__all__ = ["slerp"]


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation of unit quaternions (w,x,y,z), t ∈ [0,1] (a
    number, or a tensor of q0's batch shape or broadcastable to [..., 1]);
    the shorter arc, a lerp where the angle is below 1e-6."""
    q0 = q0 / torch.linalg.norm(q0, dim=-1, keepdim=True)
    q1 = q1 / torch.linalg.norm(q1, dim=-1, keepdim=True)
    dot = torch.sum(q0 * q1, -1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_t = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    t = t[..., None] if t.dim() == q0.dim() - 1 else t
    near = sin_t < 1e-6
    safe = torch.where(near, torch.ones_like(sin_t), sin_t)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe)
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)
