"""AABB space: coordinate normalization + ray test (port of
nr3d_lib_tpu/models/spatial/aabb.py `AABBSpace`, `AABBDynamicSpace`)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.graphics.raytest import ray_box_intersection

__all__ = ["AABBSpace", "AABBDynamicSpace"]


class AABBSpace(nn.Module):
    """Axis-aligned box space mapping world coordinates into [-1,1]^3.
    State: the buffer ``aabb`` [2, 3] (min, max)."""

    def __init__(self, aabb=None, *, center=None, radius=None, device=None):
        super().__init__()
        if aabb is None:
            c = torch.zeros(3) if center is None else \
                torch.as_tensor(center, dtype=torch.float32)
            r = torch.ones(3) * (1.0 if radius is None else
                                 torch.as_tensor(radius, dtype=torch.float32))
            aabb = torch.stack([c - r, c + r])
        self.register_buffer("aabb", torch.as_tensor(
            aabb, dtype=torch.float32).to(device))

    @property
    def center(self) -> torch.Tensor:
        return (self.aabb[0] + self.aabb[1]) * 0.5

    @property
    def radius3d(self) -> torch.Tensor:
        return (self.aabb[1] - self.aabb[0]) * 0.5

    def normalize_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """World rays → normalized-space rays (dir NOT re-normalized so t is
        shared between spaces)."""
        return (rays_o - self.center) / self.radius3d, rays_d / self.radius3d

    def ray_test(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 near: Optional[float] = None, far: Optional[float] = None
                 ) -> Dict[str, torch.Tensor]:
        """Slab test against the box; full-size arrays plus a hit mask."""
        t_near, t_far, hit = ray_box_intersection(
            rays_o, rays_d, self.aabb[0], self.aabb[1],
            t_min=near or 0.0, t_max=far or 1e10)
        return {"near": t_near, "far": t_far, "mask": hit,
                "num_rays": rays_o.shape[0], "rays_o": rays_o,
                "rays_d": rays_d}


class AABBDynamicSpace(AABBSpace):
    """AABB space + time normalization over the keyframe span. State: the
    buffers ``aabb`` and ``ts_keyframes``."""

    def __init__(self, aabb=None, ts_keyframes=None, *, device=None, **kw):
        super().__init__(aabb, device=device, **kw)
        self.register_buffer("ts_keyframes", torch.as_tensor(
            [0.0, 1.0] if ts_keyframes is None else ts_keyframes,
            dtype=torch.float32).to(device))

    def normalize_ts(self, ts: torch.Tensor) -> torch.Tensor:
        """Time → [-1, 1] over the keyframe span."""
        t0, t1 = self.ts_keyframes[0], self.ts_keyframes[-1]
        return (ts - t0) / torch.clamp(t1 - t0, min=1e-8) * 2.0 - 1.0

    def unnormalize_ts(self, ts: torch.Tensor) -> torch.Tensor:
        t0, t1 = self.ts_keyframes[0], self.ts_keyframes[-1]
        return (ts + 1.0) * 0.5 * (t1 - t0) + t0
