"""Sphere tracing of a neural SDF (port of nr3d_lib_tpu/graphics/
sphere_trace.py `RayStatus`, `SphereTracer`, `sphere_trace`).

Every ray steps t += scale·sdf in one dense batch, all rays each
iteration; a ray whose |sdf| falls under the hit threshold is HIT, one
past `far` is OUT. With an occupancy grid the trace starts a step before
the first occupied sample of an occupancy march
(`ops.occgrid_march.occgrid_march_dense`, B5 on the card).

The JAX version loops in a `lax.while_loop` that stops as soon as no ray
is alive. Once no ray is alive the loop body leaves t and the status as
they are, so any count of iterations at or past that point gives the same
t bit for bit. The port tests for a live ray every `check_every`
iterations (one host sync each), so it runs the JAX loop's iterations
rounded up to a multiple of `check_every` (at most `max_iters`); 0 runs
all `max_iters` with no sync.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from nr3d_lib_tpu_torch.ops.occgrid_march import occgrid_march_dense

__all__ = ["SphereTracer", "sphere_trace", "RayStatus"]


class RayStatus:
    ALIVE = 0
    HIT = 1
    OUT = 2


class SphereTracer:
    """The tracer's settings, with `trace` as the call."""

    def __init__(self, *, distance_scale: float = 1.0,
                 hit_threshold: float = 5e-4, max_march_iters: int = 64,
                 drop_alive_rate: float = 0.0,
                 occ_grid: Optional[torch.Tensor] = None,
                 check_every: int = 8):
        self.distance_scale = distance_scale
        self.hit_threshold = hit_threshold
        self.max_march_iters = max_march_iters
        self.occ_grid = occ_grid
        self.check_every = check_every

    def trace(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
              near: torch.Tensor, far: torch.Tensor,
              sdf_query: Callable[[torch.Tensor], torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        return sphere_trace(rays_o, rays_d, near, far, sdf_query,
                            distance_scale=self.distance_scale,
                            hit_threshold=self.hit_threshold,
                            max_iters=self.max_march_iters,
                            occ_grid=self.occ_grid,
                            check_every=self.check_every)


def sphere_trace(rays_o: torch.Tensor, rays_d: torch.Tensor,
                 near: torch.Tensor, far: torch.Tensor,
                 sdf_query: Callable[[torch.Tensor], torch.Tensor], *,
                 distance_scale: float = 1.0, hit_threshold: float = 5e-4,
                 max_iters: int = 64,
                 occ_grid: Optional[torch.Tensor] = None,
                 occ_march_steps: int = 128, check_every: int = 8
                 ) -> Dict:
    """Trace normalized-space rays (unit directions) to the SDF's zero
    crossing → {t, x, sdf, status, hit, iters}: status ∈ RayStatus,
    `iters` the iterations run. The loop runs under no_grad (the traced
    depth places samples; it is not differentiated, as in JAX); the final
    `sdf_query` at the traced points keeps its gradient."""
    r = rays_o.shape[0]
    t0 = near
    if occ_grid is not None:
        tt, _, mask = occgrid_march_dense(
            occ_grid, rays_o, rays_d, near, far, n_steps=occ_march_steps,
            step_size=float(2.0 / occ_march_steps))
        # the first occupied sample of each ray; a ray with none traces
        # from `near` (a stale grid must not turn hits into misses)
        first = torch.argmax(mask.to(torch.int32), -1)
        has = mask.any(-1)
        t_seed = tt.gather(-1, first[:, None])[:, 0]
        t0 = torch.where(has, torch.maximum(t_seed - 2.0 / occ_march_steps,
                                            near), near)

    with torch.no_grad():
        t0 = t0.detach()
        t = t0
        status = torch.where(near < far, RayStatus.ALIVE,
                             RayStatus.OUT).to(torch.int32)
        hit_code = torch.full_like(status, RayStatus.HIT)
        out_code = torch.full_like(status, RayStatus.OUT)
        it = 0
        while it < max_iters:
            if check_every and it % check_every == 0 and \
                    not bool((status == RayStatus.ALIVE).any()):
                break
            x = rays_o + rays_d * t[:, None]
            sdf = sdf_query(x).reshape(r) * distance_scale
            alive = status == RayStatus.ALIVE
            # signed stepping: an overshoot walks back to the crossing; a
            # ray held at its start with sdf < 0 began inside: a hit
            hit = alive & ((torch.abs(sdf) < hit_threshold)
                           | ((sdf < 0) & (t <= t0 + 1e-9)))
            step = torch.clamp(torch.abs(sdf), min=hit_threshold * 0.5) * \
                torch.sign(sdf)
            t_new = torch.where(alive & ~hit, torch.maximum(t + step, t0), t)
            out = alive & (t_new > far)
            status = torch.where(hit, hit_code,
                                 torch.where(out, out_code, status))
            t = t_new
            it += 1
    x = rays_o + rays_d * t[:, None]
    sdf = sdf_query(x).reshape(r)
    return {"t": t, "x": x, "sdf": sdf, "status": status,
            "hit": status == RayStatus.HIT, "iters": it}
