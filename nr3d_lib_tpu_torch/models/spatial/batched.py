"""Batched block spaces: one AABB per object instance (port of
nr3d_lib_tpu/models/spatial/batched.py `BatchedBlockSpace`,
`BatchedDynamicSpace`). Rays and coordinates carry the instance index
`bidx` explicitly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.graphics.raytest import ray_box_intersection

__all__ = ["BatchedBlockSpace", "BatchedDynamicSpace"]


class BatchedBlockSpace(nn.Module):
    """B instance boxes. State: the buffer ``aabb`` [B, 2, 3]; the unit
    box [-1, 1]^3 for each instance when none is given. `device=None`
    means CUDA."""

    def __init__(self, aabb=None, *, n_batch: Optional[int] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        if aabb is None:
            if n_batch is None:
                raise ValueError("BatchedBlockSpace needs aabb or n_batch")
            unit = torch.stack([-torch.ones(3), torch.ones(3)])
            aabb = unit[None].repeat(n_batch, 1, 1)
        self.register_buffer("aabb", torch.as_tensor(
            aabb, dtype=torch.float32).to(device))

    @property
    def n_batch(self) -> int:
        return self.aabb.shape[0]

    def center(self, bidx: torch.Tensor) -> torch.Tensor:
        a = self.aabb[bidx]
        return (a[..., 0, :] + a[..., 1, :]) * 0.5

    def radius3d(self, bidx: torch.Tensor) -> torch.Tensor:
        a = self.aabb[bidx]
        return (a[..., 1, :] - a[..., 0, :]) * 0.5

    def normalize_coords(self, x: torch.Tensor, bidx: torch.Tensor
                         ) -> torch.Tensor:
        return (x - self.center(bidx)) / self.radius3d(bidx)

    def unnormalize_coords(self, x: torch.Tensor, bidx: torch.Tensor
                           ) -> torch.Tensor:
        return x * self.radius3d(bidx) + self.center(bidx)

    def normalize_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                       bidx: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each ray into its instance's normalized space (the direction
        scaled, not re-normalized, so t is shared)."""
        r = self.radius3d(bidx)
        return (rays_o - self.center(bidx)) / r, rays_d / r

    def ray_test(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 bidx: torch.Tensor, near: Optional[float] = None,
                 far: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """Each ray against its instance's box."""
        a = self.aabb[bidx]
        t_near, t_far, hit = ray_box_intersection(
            rays_o, rays_d, a[..., 0, :], a[..., 1, :], t_min=near or 0.0,
            t_max=far or 1e10)
        return {"near": t_near, "far": t_far, "mask": hit, "bidx": bidx,
                "num_rays": rays_o.shape[0], "rays_o": rays_o,
                "rays_d": rays_d}


class BatchedDynamicSpace(BatchedBlockSpace):
    """Per-instance box and time range: instance b's timestamps in
    ts_range[b] = [start, stop] map to [-1, 1]. State: ``aabb`` and
    ``ts_range`` [B, 2]."""

    def __init__(self, aabb=None, *, ts_range=None,
                 n_batch: Optional[int] = None, device=None):
        super().__init__(aabb, n_batch=n_batch, device=device)
        device = self.aabb.device
        if ts_range is None:
            ts_range = torch.tensor([[-1.0, 1.0]]).repeat(self.n_batch, 1)
        self.register_buffer("ts_range", torch.as_tensor(
            ts_range, dtype=torch.float32).to(device))

    @staticmethod
    def normalize_all_ts_keyframes(all_ts: torch.Tensor):
        """Per-instance keyframe lists [B, K] → (ts_range [B, 2], the
        keyframes mapped to [-1, 1] [B, K])."""
        rng = torch.stack([all_ts.amin(-1), all_ts.amax(-1)], -1)
        mid = (rng[:, 0:1] + rng[:, 1:2]) * 0.5
        half = torch.clamp((rng[:, 1:2] - rng[:, 0:1]) * 0.5, min=1e-8)
        return rng, (all_ts - mid) / half

    def _range(self, bidx: torch.Tensor):
        r = self.ts_range[torch.clamp(bidx, min=0)]
        return (r[..., 0] + r[..., 1]) * 0.5, (r[..., 1] - r[..., 0]) * 0.5

    def normalize_ts(self, ts: torch.Tensor, bidx: torch.Tensor
                     ) -> torch.Tensor:
        mid, half = self._range(bidx)
        return (ts - mid) / torch.clamp(half, min=1e-8)

    def unnormalize_ts(self, ts: torch.Tensor, bidx: torch.Tensor
                       ) -> torch.Tensor:
        mid, half = self._range(bidx)
        return ts * half + mid

    def sample_pts_uniform(self, generator: torch.Generator,
                           n_per_batch: int):
        """→ (x [B, n, 3] in [-1,1), bidx [B, n], ts [B, n] in [-1,1)),
        uniform, on the generator's device."""
        b, dev = self.n_batch, generator.device
        x = torch.rand((b, n_per_batch, 3), generator=generator,
                       device=dev) * 2.0 - 1.0
        ts = torch.rand((b, n_per_batch), generator=generator,
                        device=dev) * 2.0 - 1.0
        bidx = torch.arange(b, device=dev)[:, None].expand(b, n_per_batch)
        return x, bidx, ts
