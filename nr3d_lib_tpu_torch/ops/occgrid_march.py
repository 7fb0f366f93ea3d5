"""Occupancy-grid ray marching (functional core).

Port of nr3d_lib_tpu/ops/occgrid_march.py: the step sequence is closed
form, so candidate samples form a dense [R, S] grid and the occupancy
lookup masks out candidates in empty voxels. Marching happens in the
normalized [-1,1]^3 space of the grid.

The voxel lookup goes through `gather_rows_lanes`, which runs the B5 kernel
for a CUDA grid and plain indexing for a CPU one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nr3d_lib_tpu_torch.graphics import _scan
from nr3d_lib_tpu_torch.ops.gather1d import gather_rows_lanes

__all__ = ["march_steps", "occgrid_query_axes", "occgrid_query",
           "occgrid_march_dense", "occgrid_march_batched_dense"]


def march_steps(near: torch.Tensor, far: torch.Tensor, n_steps: int,
                step_size: float, dt_gamma: float = 0.0,
                max_step_size: Optional[float] = None,
                u: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form step sequence per ray.

    Returns (t [R,S], dt [R,S], in_range [R,S]) with
    dt_i = clip(step_size·(1+γ)^i, ·, max_step_size), t cumulative from
    near and sampled at t_start + u·dt: `u` [R,S] in [0,1) jitters the
    samples (the JAX version's `perturb_key` draw, handed in), None
    takes the midpoints."""
    r = near.shape[0]
    i = torch.arange(n_steps, dtype=near.dtype, device=near.device)
    if dt_gamma > 0.0:
        dt = step_size * torch.pow(1.0 + dt_gamma, i)
        if max_step_size is not None:
            dt = torch.clamp(dt, max=max_step_size)
    else:
        dt = torch.full((n_steps,), step_size, dtype=near.dtype,
                        device=near.device)
    t_end = _scan.cumsum(dt, 0)
    t_start = (t_end - dt)[None, :] + near[:, None]          # [R,S]
    dt = dt[None, :].expand(r, n_steps)
    t = t_start + (0.5 if u is None else u) * dt
    in_range = (t < far[:, None]) & (t_start >= near[:, None] - 1e-9)
    return t, dt, in_range


def grid_rows_lanes(shp, x0: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor):
    """Voxel of each query in the grid viewed as [r0·r1, r2]: (row, lane,
    in_bounds); out-of-range coordinates are clamped into the grid."""
    idxs, inb = [], None
    for xi, ri in zip((x0, x1, x2), shp):
        u = (xi + 1.0) * 0.5
        ii = torch.floor(u * float(ri)).to(torch.int32)
        ok = (ii >= 0) & (ii < ri)
        inb = ok if inb is None else (inb & ok)
        idxs.append(ii.clamp(0, ri - 1))
    i0, i1, i2 = idxs
    return i0 * shp[1] + i1, i2, inb


def occgrid_query_axes(occ: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                       x2: torch.Tensor) -> torch.Tensor:
    """Occupancy of a binary grid occ [r0,r1,r2] at normalized coordinates
    given per axis (same-shape arrays). Out-of-range queries are False."""
    shp = occ.shape
    row, i2, inb = grid_rows_lanes(shp, x0, x1, x2)
    vals = gather_rows_lanes(
        occ.reshape(shp[0] * shp[1], shp[2]).to(torch.float32), row, i2) > 0.5
    return vals & inb


def occgrid_query(occ: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Query a binary occupancy grid at normalized positions x ∈ [-1,1]^3."""
    return occgrid_query_axes(occ, x[..., 0], x[..., 1], x[..., 2])


def occgrid_march_dense(occ: torch.Tensor, rays_o: torch.Tensor,
                        rays_d: torch.Tensor, near: torch.Tensor,
                        far: torch.Tensor, *, n_steps: int, step_size: float,
                        dt_gamma: float = 0.0,
                        max_step_size: Optional[float] = None,
                        u: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """March normalized-space rays through an occupancy grid → dense
    (t [R,S], dt [R,S], mask [R,S]), mask = in-range ∧ voxel-occupied;
    `u` jitters the steps as in `march_steps`."""
    t, dt, in_range = march_steps(near, far, n_steps, step_size, dt_gamma,
                                  max_step_size, u)
    xs = [rays_o[:, None, a] + rays_d[:, None, a] * t for a in range(3)]
    occ_hit = occgrid_query_axes(occ, *xs)
    return t, dt, in_range & occ_hit


def occgrid_march_batched_dense(occ: torch.Tensor, bidx: torch.Tensor,
                                rays_o: torch.Tensor, rays_d: torch.Tensor,
                                near: torch.Tensor, far: torch.Tensor, *,
                                n_steps: int, step_size: float,
                                dt_gamma: float = 0.0,
                                max_step_size: Optional[float] = None,
                                u: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The batched march: occ [B, r0, r1, r2], bidx [R] picks each ray's
    grid (bidx < 0: no sample is occupied) → (t, dt, mask) [R, S]. The
    grids are read as one [B·r0·r1, r2] table through
    `gather_rows_lanes` (B5 for a CUDA grid, as the JAX version on the
    TPU; a plain take on the CPU)."""
    t, dt, in_range = march_steps(near, far, n_steps, step_size, dt_gamma,
                                  max_step_size, u)
    shp = occ.shape[1:]
    xs = [rays_o[:, None, a] + rays_d[:, None, a] * t for a in range(3)]
    row, i2, inb = grid_rows_lanes(shp, *xs)
    b = torch.clamp(bidx, min=0).to(row.dtype)[:, None]
    vals = gather_rows_lanes(
        occ.reshape(-1, shp[2]).to(torch.float32),
        b * (shp[0] * shp[1]) + row, i2) > 0.5
    occ_hit = vals & inb & (bidx >= 0)[:, None]
    return t, dt, in_range & occ_hit
