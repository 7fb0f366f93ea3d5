"""Camera math: pixel grids, pinhole projection and rays, the OpenCV and
fisheye distortions and their fixed-iteration inverses, frustum culling,
view normalization, pose interpolation and camera paths (port of
nr3d_lib_tpu/graphics/cameras.py).

Convention: OpenCV camera frame (x right, y down, z forward); world pose
c2w [..., 3 or 4, 4]. Functions that make tensors from nothing take a
`device` (None means CUDA); the others compute on their inputs' device.
`smoothed_motion_interpolation` and the circle geometry stay in numpy on
the host, as in the JAX version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.maths.slerp import slerp
from nr3d_lib_tpu_torch.maths.transforms import (axis_angle_to_matrix,
                                                 matrix_to_quaternion,
                                                 quaternion_to_matrix)

__all__ = [
    "pinhole_lift", "pinhole_project", "pinhole_get_rays",
    "opencv_distort", "opencv_undistort", "fisheye_distort",
    "pixel_grid", "frustum_culling_aabb",
    "normalize_views", "look_at", "spherical_camera_path", "interp_poses",
]


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """[h, w, 2] pixel-center coordinates (x, y)."""
    dev = resolve_device(device)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=dev) + 0.5,
                            torch.arange(w, dtype=dtype, device=dev) + 0.5,
                            indexing="ij")
    return torch.stack([xs, ys], -1)


def pinhole_lift(uv: torch.Tensor, intr: torch.Tensor,
                 depth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixels → camera-space points. uv [..., 2]; intr [..., 3, 3]; depth
    [...] (default 1)."""
    fx = intr[..., 0, 0]
    fy = intr[..., 1, 1]
    cx = intr[..., 0, 2]
    cy = intr[..., 1, 2]
    sk = intr[..., 0, 1]
    z = torch.ones_like(uv[..., 0]) if depth is None else depth
    y = (uv[..., 1] - cy) / fy * z
    x = (uv[..., 0] - cx - sk * (uv[..., 1] - cy) / fy) / fx * z
    return torch.stack([x, y, z], -1)


def pinhole_project(x_cam: torch.Tensor, intr: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-space points → (uv [..., 2], depth)."""
    z = x_cam[..., 2]
    u = x_cam[..., 0] / z * intr[..., 0, 0] + intr[..., 0, 2]
    v = x_cam[..., 1] / z * intr[..., 1, 1] + intr[..., 1, 2]
    return torch.stack([u, v], -1), z


def pinhole_get_rays(uv: torch.Tensor, intr: torch.Tensor, c2w: torch.Tensor,
                     normalize: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixels + pose → world rays (origins, directions)."""
    dirs_cam = pinhole_lift(uv, intr)
    r = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    dirs = torch.einsum("...ij,...j->...i", r, dirs_cam)
    if normalize:
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return torch.broadcast_to(t, dirs.shape), dirs


# ---------------------------------------------------------------- distortion
def opencv_distort(xn: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Normalized camera coordinates [..., 2] → distorted, the OpenCV
    model; dist [..., ≥4] = (k1, k2, p1, p2[, k3, k4, k5, k6]), the
    missing ones 0."""
    def get(i):
        return dist[..., i] if dist.shape[-1] > i else \
            torch.zeros_like(dist[..., 0])

    k1, k2, p1, p2 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    k3, k4, k5, k6 = get(4), get(5), get(6), get(7)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = (1 + r2 * (k1 + r2 * (k2 + r2 * k3))) / \
        (1 + r2 * (k4 + r2 * (k5 + r2 * k6)))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], -1)


def opencv_undistort(xd: torch.Tensor, dist: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """The inverse of `opencv_distort` by `iters` fixed-point steps
    xn ← xd − (distort(xn) − xn)."""
    dist = torch.as_tensor(dist, dtype=xd.dtype, device=xd.device)
    xn = xd
    for _ in range(iters):
        xn = xd - (opencv_distort(xn, dist) - xn)
    return xn


def fisheye_distort(xn: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Equidistant fisheye: r → θ(1 + k1θ² + k2θ⁴ + k3θ⁶ + k4θ⁸) with
    θ = atan r; dist [..., 4]."""
    x, y = xn[..., 0], xn[..., 1]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan(r)
    t2 = theta * theta
    k1, k2, k3, k4 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8),
                        torch.ones_like(r))
    return torch.stack([x * scale, y * scale], -1)


def fisheye_undistort(xd: torch.Tensor, dist: torch.Tensor,
                      iters: int = 10) -> torch.Tensor:
    """The inverse of `fisheye_distort`: `iters` Newton steps for θ from
    θ_d = θ(1 + k1θ² + …), then r = tan θ."""
    dist = torch.as_tensor(dist, dtype=xd.dtype, device=xd.device)
    k1, k2, k3, k4 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    r_d = torch.linalg.norm(xd, dim=-1)
    theta = r_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - r_d
        fp = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - f / torch.where(torch.abs(fp) > 1e-6, fp,
                                        torch.sign(fp) * 1e-6 + 1e-12)
    scale = torch.where(r_d > 1e-8,
                        torch.tan(theta) / torch.clamp(r_d, min=1e-8),
                        torch.ones_like(r_d))
    return xd * scale[..., None]


# ----------------------------------------------------------------- frustums
def frustum_culling_aabb(intr: torch.Tensor, c2w: torch.Tensor,
                         hw: Tuple[int, int], aabb: torch.Tensor,
                         near: float = 1e-3, far: float = 100.0
                         ) -> torch.Tensor:
    """Conservative frustum ↔ AABB test; c2w [..., 4, 4] may be batched,
    aabb [2, 3] (min, max) → bool [...], False where the box is surely
    outside. The box is out when its 8 corners lie outside one frustum
    half-space, or the frustum's 8 corners outside one box face."""
    h, w = hw
    box = torch.stack(torch.meshgrid(aabb[:, 0], aabb[:, 1], aabb[:, 2],
                                     indexing="ij"), -1).reshape(8, 3)
    r_c2w = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    cam = torch.einsum("...ji,...kj->...ki", r_c2w, box - t[..., None, :])
    fx, fy = intr[..., 0, 0, None], intr[..., 1, 1, None]
    cx, cy = intr[..., 0, 2, None], intr[..., 1, 2, None]
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    # u = fx·x/z + cx < 0  ⇔  fx·x + cx·z < 0 for z > 0
    out = torch.stack([
        torch.all(z < near, -1), torch.all(z > far, -1),
        torch.all(fx * x + cx * z < 0, -1),
        torch.all(fx * x + (cx - w) * z > 0, -1),
        torch.all(fy * y + cy * z < 0, -1),
        torch.all(fy * y + (cy - h) * z > 0, -1)], -1)
    frustum_rejects = torch.any(out, -1)

    dev, dt = c2w.device, c2w.dtype
    us = torch.tensor([0.0, float(w)], dtype=dt, device=dev)
    vs = torch.tensor([0.0, float(h)], dtype=dt, device=dev)
    uu, vv, dd = torch.meshgrid(us, vs, torch.tensor([near, far], dtype=dt,
                                                     device=dev),
                                indexing="ij")
    xc = (uu - cx[..., None, None]) / fx[..., None, None] * dd
    yc = (vv - cy[..., None, None]) / fy[..., None, None] * dd
    fc_cam = torch.stack([xc, yc, dd.expand_as(xc)], -1)
    fc_cam = fc_cam.reshape(fc_cam.shape[:-4] + (8, 3))
    fc_w = torch.einsum("...ij,...kj->...ki", r_c2w, fc_cam) + t[..., None, :]
    box_rejects = torch.any(torch.cat([
        torch.all(fc_w < aabb[None, 0], -2),
        torch.all(fc_w > aabb[None, 1], -2)], -1), -1)
    return ~(frustum_rejects | box_rejects)


# ------------------------------------------------------------ normalization
def normalize_views(c2ws: torch.Tensor, target_radius: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recentre and rescale a camera rig [N, 4, 4] so that the cameras lie
    within `target_radius` of the origin → (new c2ws, centre, scale)."""
    centers = c2ws[..., :3, 3]
    mid = torch.mean(centers, dim=0)
    radius = torch.max(torch.linalg.norm(centers - mid, dim=-1))
    scale = target_radius / torch.clamp(radius, min=1e-8)
    new = c2ws.clone()
    new[..., :3, 3] = (centers - mid) * scale
    return new, mid, scale


# -------------------------------------------------------------- camera paths
def look_at(eye, target, up=(0.0, 1.0, 0.0), device=None) -> torch.Tensor:
    """c2w [4, 4] with the OpenCV convention (z forward). On `eye`'s device
    when it is a tensor and `device` is None."""
    if device is None and isinstance(eye, torch.Tensor):
        dev = eye.device
    else:
        dev = resolve_device(device)

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32).to(dev)

    eye, target, up = vec(eye), vec(target), vec(up)
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.clamp(torch.linalg.norm(right), min=1e-8)
    down = torch.linalg.cross(fwd, right)
    m = torch.eye(4, dtype=torch.float32, device=dev)
    m[:3, :3] = torch.stack([right, down, fwd], -1)
    m[:3, 3] = eye
    return m


def spherical_camera_path(n_frames: int, radius: float = 3.0,
                          elevation: float = 0.3, center=(0.0, 0.0, 0.0),
                          device=None) -> torch.Tensor:
    """Turntable orbit → [n_frames, 4, 4]."""
    dev = resolve_device(device)
    center = torch.as_tensor(center, dtype=torch.float32).to(dev)
    angles = np.linspace(0, 2 * np.pi, n_frames, endpoint=False,
                         dtype=np.float32)
    poses = []
    for a in angles:
        eye = center + radius * torch.as_tensor(np.asarray(
            [np.cos(a) * np.cos(elevation), np.sin(elevation),
             np.sin(a) * np.cos(elevation)], np.float32)).to(dev)
        poses.append(look_at(eye, center))
    return torch.stack(poses)


def interp_poses(c2w0: torch.Tensor, c2w1: torch.Tensor, alpha
                 ) -> torch.Tensor:
    """[4, 4] poses → [4, 4]: slerp of the rotations, lerp of the
    translations."""
    q = slerp(matrix_to_quaternion(c2w0[:3, :3]),
              matrix_to_quaternion(c2w1[:3, :3]), alpha)
    m = torch.eye(4, dtype=c2w0.dtype, device=c2w0.device)
    m[:3, :3] = quaternion_to_matrix(q)
    m[:3, 3] = c2w0[:3, 3] * (1 - alpha) + c2w1[:3, 3] * alpha
    return m


def smoothed_motion_interpolation(full_range: float, n: int,
                                  uniform_proportion: float = 1.0 / 3.0
                                  ) -> np.ndarray:
    """Ease-in/ease-out spacing of n samples over [0, full_range]: a blend
    of the uniform spacing (weight `uniform_proportion`) and a
    cosine-eased one (numpy, float64)."""
    u = np.linspace(0.0, np.pi, n)
    eased = (1.0 - np.cos(u)) * 0.5
    lin = np.linspace(0.0, 1.0, n)
    w = float(np.clip(uniform_proportion, 0.0, 1.0))
    return full_range * (w * lin + (1.0 - w) * eased)


def _circle_basis(three_cam_centers):
    """The three centres snapped to the sphere of the farthest one, its
    radius, and the unit normal of their plane (numpy, float64)."""
    c = np.asarray(three_cam_centers, np.float64)
    norms = np.linalg.norm(c, axis=-1)
    radius = float(norms.max())
    c = c * radius / norms[:, None]
    up = np.cross(c[1] - c[0], c[2] - c[0])
    up = up / max(np.linalg.norm(up), 1e-12)
    return c, radius, up


def path_small_circle(three_cam_centers, n_frames: int,
                      device=None) -> torch.Tensor:
    """[n_frames, 4, 4]: a sweep along the arc from the first of three
    reference centres toward the third, looking at the origin, eased in
    and out."""
    dev = resolve_device(device)
    c, radius, up = _circle_basis(three_cam_centers)
    chord = np.linalg.norm(c[2] - c[0])
    full_angle = 2.0 * np.arcsin(min(chord / (2.0 * radius), 1.0))
    up32 = up.astype(np.float32)
    poses = []
    for a in smoothed_motion_interpolation(full_angle, n_frames):
        r = axis_angle_to_matrix(torch.from_numpy(
            (up * a).astype(np.float32))).numpy()
        poses.append(look_at(r @ c[0], np.zeros(3), up=up32, device=dev))
    return torch.stack(poses)


def path_spherical_spiral(three_cam_centers, n_frames: int,
                          n_rots: float = 2.2, up_angle_start: float = 0.0,
                          up_angle: float = np.pi / 3.0,
                          device=None) -> torch.Tensor:
    """[n_frames, 4, 4]: a spiral on the reference circle's sphere, `n_rots`
    turns rising from `up_angle_start` to `up_angle` toward the circle's
    pole, looking at the origin."""
    dev = resolve_device(device)
    c, radius, up = _circle_basis(three_cam_centers)
    e0 = c[0] / np.linalg.norm(c[0])
    e0 = e0 - up * np.dot(up, e0)
    e0 = e0 / max(np.linalg.norm(e0), 1e-12)
    e1 = np.cross(up, e0)
    thetas = np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames)
    phis = np.linspace(up_angle_start, up_angle, n_frames)
    up32 = up.astype(np.float32)
    poses = []
    for th, ph in zip(thetas, phis):
        eye = radius * (np.cos(ph) * (np.cos(th) * e0 + np.sin(th) * e1)
                        + np.sin(ph) * up)
        poses.append(look_at(eye.astype(np.float32), np.zeros(3), up=up32,
                             device=dev))
    return torch.stack(poses)


def path_interpolation(key_poses, n_frames: int) -> torch.Tensor:
    """Resample a key-pose trajectory [N, 4, 4] to [n_frames, 4, 4] by
    `interp_poses` within each segment."""
    key_poses = torch.as_tensor(key_poses).reshape(-1, 4, 4)
    n_keys = key_poses.shape[0]
    poses = []
    for t in np.linspace(0.0, n_keys - 1.0, n_frames):
        i = min(int(np.floor(t)), n_keys - 2)
        poses.append(interp_poses(key_poses[i], key_poses[i + 1],
                                  float(t - i)))
    return torch.stack(poses)
