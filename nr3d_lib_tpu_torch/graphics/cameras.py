"""Camera math: pixel grids, pinhole rays, look-at poses and the turntable
orbit (port of nr3d_lib_tpu/graphics/cameras.py `pixel_grid`,
`pinhole_lift`, `pinhole_get_rays`, `look_at`, `spherical_camera_path`;
the distortions, the culling and the other camera paths wait in
ROADMAP.md A14).

Convention: OpenCV camera frame (x right, y down, z forward); world pose
c2w [..., 3 or 4, 4]. Functions that make tensors from nothing take a
`device` (None means CUDA); the others compute on their inputs' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nr3d_lib_tpu_torch.device import resolve_device

__all__ = ["pixel_grid", "pinhole_lift", "pinhole_get_rays", "look_at",
           "spherical_camera_path"]


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
