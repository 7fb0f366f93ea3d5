"""The occupancy march's inputs at the benchmark cells' shapes, for the GPU
tests of the fused march-and-budget kernel (`test_torch_kernels_gpu.py`)
and `chip_smoke.py`'s timing of it, made with the port's own code.

Both cells march a 64³ grid that marks the cells within 0.05 of a sphere ∪
rounded box (nr3d_lib's NeuS object), 96 steps of 2/96, from cameras on a
seeded orbit of radius 3 (800², focal 1111, elevation −30° to 60°).
`nerf_w4_render_800`: one whole frame (640,000 rays), budget 24 (a
quarter of S), the ray mask, no jitter. `neus_w4_train_16k`: 16,384 rays
drawn uniformly over the pixels of 100 views, budget 48 (half of S),
jitter drawn [R, S], no ray mask."""

import math

import torch

from nr3d_lib_tpu_torch.graphics.cameras import (look_at, pinhole_get_rays,
                                                pixel_grid)
from nr3d_lib_tpu_torch.models.spatial.aabb import AABBSpace

RES, N_STEPS, STEP, BAND = 64, 96, 2.0 / 96, 0.05
HW, FOCAL, RADIUS, ELEV_DEG = (800, 800), 1111.0, 3.0, (-30.0, 60.0)
N_VIEWS, N_TRAIN_RAYS = 100, 16384
# name → (budget, ray mask, jitter)
CELLS = {"nerf_w4_render_800": (24, True, False),
         "neus_w4_train_16k": (48, False, True)}


def band_grid(dev) -> torch.Tensor:
    """[RES]³ bool: the cells whose centre lies within BAND of the
    sphere (centre (0.22, 0, 0), radius 0.34) ∪ rounded box (centre
    (−0.22, 0, 0), half size 0.26, rounding 0.04)."""
    lin = (torch.arange(RES, dtype=torch.float32, device=dev) + 0.5) / \
        RES * 2.0 - 1.0
    x = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    c_sph = torch.tensor([0.22, 0.0, 0.0], device=dev)
    c_box = torch.tensor([-0.22, 0.0, 0.0], device=dev)
    d_sph = torch.linalg.norm(x - c_sph, dim=-1) - 0.34
    q = torch.abs(x - c_box) - 0.26
    d_box = (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) +
             torch.clamp(torch.amax(q, -1), max=0.0) - 0.04)
    return torch.abs(torch.minimum(d_sph, d_box)) < BAND


def _orbit_pose(gen: torch.Generator) -> torch.Tensor:
    """c2w [4, 4] looking at the origin from a seeded point of the orbit
    (OpenCV axes, z up in the world)."""
    a, e = torch.rand(2, generator=gen, device=gen.device).tolist()
    az = a * 2.0 * math.pi
    lo, hi = (math.radians(v) for v in ELEV_DEG)
    el = lo + (hi - lo) * e
    eye = [RADIUS * math.cos(el) * math.cos(az),
           RADIUS * math.cos(el) * math.sin(az), RADIUS * math.sin(el)]
    return look_at(eye, (0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
                   device=gen.device)


def cell(name: str, dev, seed: int = 0) -> dict:
    """The march's inputs in `name` → dict(occ, o, d (normalized), near,
    far, ray_mask, u, n_steps, step_size, budget)."""
    budget, masked, jitter = CELLS[name]
    gen = torch.Generator(dev).manual_seed(seed)
    h, w = HW
    intr = torch.tensor([[FOCAL, 0.0, w / 2], [0.0, FOCAL, h / 2],
                         [0.0, 0.0, 1.0]], device=dev)
    if jitter:
        poses = torch.stack([_orbit_pose(gen) for _ in range(N_VIEWS)])
        k = torch.randint(0, N_VIEWS * h * w, (N_TRAIN_RAYS,), generator=gen,
                          device=dev)
        view, px = k // (h * w), k % (h * w)
        uv = torch.stack([(px % w).float() + 0.5, (px // w).float() + 0.5],
                         -1)
        o, d = pinhole_get_rays(uv, intr, poses[view])
        u = torch.rand((N_TRAIN_RAYS, N_STEPS), generator=gen, device=dev)
    else:
        uv = pixel_grid(h, w, device=dev).reshape(-1, 2)
        o, d = pinhole_get_rays(uv, intr, _orbit_pose(gen))
        u = None
    o, d = o.contiguous(), d.contiguous()
    space = AABBSpace(aabb=[[-1.0] * 3, [1.0] * 3], device=dev)
    rt = space.ray_test(o, d)
    o_n, d_n = space.normalize_rays(o, d)
    return dict(occ=band_grid(dev), o=o_n, d=d_n, near=rt["near"],
                far=rt["far"], ray_mask=rt["mask"] if masked else None, u=u,
                n_steps=N_STEPS, step_size=STEP, budget=budget)
