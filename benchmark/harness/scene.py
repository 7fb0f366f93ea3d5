"""The analytic scene, the cameras on their orbit, the training views and
the ray sampler: the inputs that a traffic file's parameters describe.
Everything is made on the device from the run's seed."""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference.common import cell_centers, pinhole_rays, rays_from_pixels


class Scene:
    """Sphere ∪ rounded box (nr3d_lib's NeuS object example), from the
    configuration's `scene` parameters."""

    def __init__(self, p: dict, device):
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        self.c_sph = t(p["sphere_center"])
        self.r_sph = float(p["sphere_radius"])
        self.c_box, self.h_box = t(p["box_center"]), float(p["box_half"])
        self.round = float(p["box_round"])
        self.bound = float(p["bounding_radius"])

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        d_sph = torch.linalg.norm(x - self.c_sph, dim=-1) - self.r_sph
        q = torch.abs(x - self.c_box) - self.h_box
        d_box = (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) +
                 torch.clamp(torch.amax(q, -1), max=0.0) - self.round)
        return torch.minimum(d_sph, d_box)

    @torch.no_grad()
    def trace(self, o: torch.Tensor, d: torch.Tensor, n_steps: int
              ) -> torch.Tensor:
        """Sphere-trace from the bounding sphere → the normal colour
        n·0.5 + 0.5 where the ray hits the surface, else 0."""
        b = torch.sum(o * d, -1)
        disc = b * b - (torch.sum(o * o, -1) - self.bound ** 2)
        t = torch.clamp(-b - torch.sqrt(torch.clamp(disc, min=0.0)), min=0.0)
        for _ in range(n_steps):
            t = t + self.sdf(o + t[:, None] * d)
        p = o + t[:, None] * d
        hit = (disc > 0) & (torch.abs(self.sdf(p)) < 1e-3)
        with torch.enable_grad():
            pr = p.detach().requires_grad_(True)
            (n,) = torch.autograd.grad(self.sdf(pr).sum(), pr)
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                            min=1e-9)
        return torch.where(hit[:, None], n * 0.5 + 0.5, 0.0)


def orbit_poses(n: int, radius: float, elev_deg, gen: torch.Generator
                ) -> torch.Tensor:
    """n cameras c2w [n, 4, 4] looking at the origin from `radius`, at
    seeded azimuths and elevations within `elev_deg` (OpenCV axes, z up
    in the world)."""
    dev = gen.device
    u = torch.rand((n, 2), generator=gen, device=dev)
    az = u[:, 0] * 2.0 * math.pi
    lo, hi = (math.radians(v) for v in elev_deg)
    el = lo + (hi - lo) * u[:, 1]
    pos = radius * torch.stack([torch.cos(el) * torch.cos(az),
                                torch.cos(el) * torch.sin(az),
                                torch.sin(el)], -1)
    fwd = -pos / radius
    up = torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    c2w = torch.zeros((n, 4, 4), device=dev)
    c2w[:, :3, 0], c2w[:, :3, 1], c2w[:, :3, 2] = right, down, fwd
    c2w[:, :3, 3] = pos
    c2w[:, 3, 3] = 1.0
    return c2w


class Views:
    """Training views: `n_views` orbit cameras, each image rendered from
    the scene. `sample(n, gen)` draws n pixels uniformly over all views
    → {o, d, rgb}."""

    def __init__(self, scene: Scene, traffic: dict, gen: torch.Generator):
        cam = traffic["camera"]
        self.hw = tuple(cam["hw"])
        self.focal = float(cam["focal"])
        self.poses = orbit_poses(traffic["n_views"], cam["orbit_radius"],
                                 cam["elevation_deg"], gen)
        n_px = self.hw[0] * self.hw[1]
        self.rgb = torch.empty((len(self.poses), n_px, 3),
                               device=gen.device)
        step = max(1, (1 << 22) // n_px)         # views traced together
        for i in range(0, len(self.poses), step):
            c2w = self.poses[i:i + step]
            o, d = pinhole_rays(c2w[:, None], self.hw, self.focal)
            self.rgb[i:i + step] = scene.trace(
                o.reshape(-1, 3), d.reshape(-1, 3), traffic["gt_trace_steps"]
            ).reshape(len(c2w), n_px, 3)

    def sample(self, n: int, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        h, w = self.hw
        k = torch.randint(0, self.rgb.shape[0] * h * w, (n,), generator=gen,
                          device=gen.device)
        view, px = k // (h * w), k % (h * w)
        u = (px % w).float() + 0.5
        v = (px // w).float() + 0.5
        o, d = rays_from_pixels(self.poses[view], u, v, self.hw, self.focal)
        return {"o": o.contiguous(), "d": d, "rgb": self.rgb[view, px]}


def band_grid(scene: Scene, res: int, band: float, device) -> torch.Tensor:
    """The served occupancy grid [res]³: the cells whose centre lies
    within `band` of the scene's surface."""
    c = cell_centers(res, device)
    return torch.abs(scene.sdf(c)).reshape((res,) * 3) < band
