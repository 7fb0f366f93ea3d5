"""Coordinate-convention conversions (port of nr3d_lib_tpu/coordinates.py).

Each function re-expresses camera-to-world poses (c2w [..., 3 or 4, 4])
whose camera axes follow one convention in another; the world frame is
unchanged. Conventions (right-handed):

  opencv : x right, y down,  z forward   (the library's native convention)
  opengl : x right, y up,    z backward
  waymo  : x forward, y left,  z up
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["opengl_to_opencv", "opencv_to_opengl", "waymo_to_opencv",
           "opencv_to_waymo", "convert_pose"]

# change of basis: the columns express the source frame's axes in the
# target's coordinates
_M = {
    ("opengl", "opencv"): np.diag([1.0, -1.0, -1.0]),
    ("opencv", "opengl"): np.diag([1.0, -1.0, -1.0]),
    # waymo → opencv: x_cv = −y_w, y_cv = −z_w, z_cv = x_w
    ("waymo", "opencv"): np.asarray([[0.0, -1.0, 0.0],
                                     [0.0, 0.0, -1.0],
                                     [1.0, 0.0, 0.0]]),
    ("opencv", "waymo"): np.asarray([[0.0, 0.0, 1.0],
                                     [-1.0, 0.0, 0.0],
                                     [0.0, -1.0, 0.0]]),
}


def convert_pose(c2w, src: str, dst: str) -> torch.Tensor:
    """R' = R @ M_dst←srcᵀ on the rotation block; a new tensor on c2w's
    device, in its dtype (a numpy array is taken as it is)."""
    c2w = torch.as_tensor(c2w)
    if src == dst:
        return c2w
    m = _M[(dst, src)] if (dst, src) in _M else \
        np.linalg.inv(_M[(src, dst)])
    m = torch.as_tensor(m, dtype=c2w.dtype, device=c2w.device)
    out = c2w.clone()
    out[..., :3, :3] = c2w[..., :3, :3] @ m.T
    return out


def opengl_to_opencv(c2w) -> torch.Tensor:
    return convert_pose(c2w, "opengl", "opencv")


def opencv_to_opengl(c2w) -> torch.Tensor:
    return convert_pose(c2w, "opencv", "opengl")


def waymo_to_opencv(c2w) -> torch.Tensor:
    return convert_pose(c2w, "waymo", "opencv")


def opencv_to_waymo(c2w) -> torch.Tensor:
    return convert_pose(c2w, "opencv", "waymo")
