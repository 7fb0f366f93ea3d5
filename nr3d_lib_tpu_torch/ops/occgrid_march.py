"""Occupancy-grid ray marching (functional core).

Port of nr3d_lib_tpu/ops/occgrid_march.py: the step sequence is closed
form, so candidate samples form a dense [R, S] grid and the occupancy
lookup masks out candidates in empty voxels. Marching happens in the
normalized [-1,1]^3 space of the grid.

The voxel lookup goes through `gather_rows_lanes`, which runs the B5 kernel
for a CUDA grid and plain indexing for a CPU one. `occgrid_march_budgeted`
marches and keeps each ray's first B occupied steps: on a CUDA grid in one
kernel (`csrc/occ_march.cu`) that never makes the [R, S] slab, on a CPU
grid as `occgrid_march_dense` then `pack_ops.dense_to_budgeted`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from nr3d_lib_tpu_torch.graphics import _scan
from nr3d_lib_tpu_torch.graphics.pack_ops import dense_to_budgeted
from nr3d_lib_tpu_torch.ops import _build
from nr3d_lib_tpu_torch.ops.gather1d import gather_rows_lanes
from nr3d_lib_tpu_torch.profile import mark_fused

__all__ = ["step_table", "march_steps", "occgrid_query_axes",
           "occgrid_query", "occgrid_march_dense", "occgrid_march_budgeted",
           "occgrid_march_batched_dense"]


def step_table(n_steps: int, step_size: float, dt_gamma: float = 0.0,
               max_step_size: Optional[float] = None,
               dtype: torch.dtype = torch.float32, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step sequence shared by every ray: (t_end − dt [S], dt [S]),
    dt_i = clip(step_size·(1+γ)^i, ·, max_step_size), t_end its cumsum."""
    i = torch.arange(n_steps, dtype=dtype, device=device)
    if dt_gamma > 0.0:
        dt = step_size * torch.pow(1.0 + dt_gamma, i)
        if max_step_size is not None:
            dt = torch.clamp(dt, max=max_step_size)
    else:
        dt = torch.full((n_steps,), step_size, dtype=dtype, device=device)
    t_end = _scan.cumsum(dt, 0)
    return t_end - dt, dt


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
    t0, dt = step_table(n_steps, step_size, dt_gamma, max_step_size,
                        near.dtype, near.device)
    t_start = t0[None, :] + near[:, None]                    # [R,S]
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


def occgrid_march_budgeted(occ: torch.Tensor, rays_o: torch.Tensor,
                           rays_d: torch.Tensor, near: torch.Tensor,
                           far: torch.Tensor, *, n_steps: int,
                           step_size: float, dt_gamma: float = 0.0,
                           max_step_size: Optional[float] = None,
                           u: Optional[torch.Tensor] = None, budget: int,
                           ray_mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """March normalized-space rays and keep each ray's first `budget`
    occupied in-range steps, in step order → (t [R,B], dt [R,B],
    valid [R,B]); unused slots are 0 with valid False. `ray_mask` [R]
    (None: every ray) leaves a ray empty; `u` [R, S] jitters as in
    `march_steps`.

    A CPU grid takes the plain route: `occgrid_march_dense`, `& ray_mask`,
    `dense_to_budgeted`. A CUDA grid launches `occ_march_budget`
    (`csrc/occ_march.cu`), which gives that route's t, dt and valid bit
    for bit, and charges `fused` to the innermost open span; any other
    device raises."""
    if occ.device.type == "cpu":
        t, dt, mask = occgrid_march_dense(
            occ, rays_o, rays_d, near, far, n_steps=n_steps,
            step_size=step_size, dt_gamma=dt_gamma,
            max_step_size=max_step_size, u=u)
        if ray_mask is not None:
            mask = mask & ray_mask[:, None]
        (t, dt), valid = dense_to_budgeted([t, dt], mask, budget)
        return t, dt, valid
    if occ.device.type != "cuda":
        raise ValueError(f"occgrid_march_budgeted: unsupported device "
                         f"{occ.device}")
    return _budgeted_cuda(occ, rays_o, rays_d, near, far, n_steps, step_size,
                          dt_gamma, max_step_size, u, budget, ray_mask)


def _lib():
    vp, i32 = _build.VP, ctypes.c_int
    return _build.load("occ_march", {"occ_march_budget": [
        vp, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ctypes.c_longlong, i32, i32, vp]})


@functools.lru_cache(maxsize=16)
def _device_step_table(n_steps, step_size, dt_gamma, max_step_size, device):
    """`step_table` in float32 on a card, made once per settings: the same
    tensors, computed by the same code, that the dense route makes every
    call."""
    return tuple(a.contiguous() for a in step_table(
        n_steps, step_size, dt_gamma, max_step_size, torch.float32, device))


def _budgeted_cuda(occ, rays_o, rays_d, near, far, n_steps, step_size,
                   dt_gamma, max_step_size, u, budget, ray_mask):
    dev = occ.device
    r = rays_o.shape[0]
    if occ.dim() != 3 or occ.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"occgrid_march_budgeted: occ must be a bool or "
                         f"uint8 [r0, r1, r2] grid, got {tuple(occ.shape)} "
                         f"{occ.dtype}")
    if budget < 1:
        raise ValueError(f"occgrid_march_budgeted: budget {budget} < 1")
    f32 = [rays_o, rays_d, near, far] + ([] if u is None else [u])
    if any(a.dtype != torch.float32 or a.device != dev for a in f32):
        raise ValueError(f"occgrid_march_budgeted: rays, near, far and u "
                         f"must be float32 on {dev}")
    if rays_o.shape != (r, 3) or rays_d.shape != (r, 3) or \
            near.shape != (r,) or far.shape != (r,):
        raise ValueError("occgrid_march_budgeted: rays must be [R, 3], "
                         "near and far [R]")
    if u is not None and u.shape != (r, n_steps):
        raise ValueError(f"occgrid_march_budgeted: u must be [{r}, "
                         f"{n_steps}], got {tuple(u.shape)}")
    if ray_mask is not None and (ray_mask.shape != (r,) or
                                 ray_mask.device != dev):
        raise ValueError(f"occgrid_march_budgeted: ray_mask must be [{r}] "
                         f"on {dev}")
    t0, dts = _device_step_table(n_steps, step_size, dt_gamma,
                                 max_step_size, dev)
    occ = occ.contiguous()
    rays_o, rays_d, near, far = (a.contiguous()
                                 for a in (rays_o, rays_d, near, far))
    if u is not None:
        u = u.contiguous()
    if ray_mask is not None:
        ray_mask = ray_mask.to(torch.bool).contiguous()
    t = torch.empty((r, budget), dtype=torch.float32, device=dev)
    dt = torch.empty((r, budget), dtype=torch.float32, device=dev)
    valid = torch.empty((r, budget), dtype=torch.bool, device=dev)
    ptr = lambda a: None if a is None else a.data_ptr()
    err = _lib().occ_march_budget(
        occ.data_ptr(), *occ.shape, t0.data_ptr(), dts.data_ptr(),
        rays_o.data_ptr(), rays_d.data_ptr(), near.data_ptr(),
        far.data_ptr(), ptr(ray_mask), ptr(u), t.data_ptr(), dt.data_ptr(),
        valid.data_ptr(), r, n_steps, budget, _build.stream_ptr(dev))
    _build.check(err, "occ_march_budget")
    _build.LAUNCHES["occ_march_budget"] += 1
    mark_fused()
    return t, dt, valid


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
