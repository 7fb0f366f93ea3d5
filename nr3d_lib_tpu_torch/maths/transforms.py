"""Rotation representations.

Port of nr3d_lib_tpu/maths/transforms.py, with the same conventions:
quaternions (w, x, y, z), unit norm; matrices act on column vectors. Only
`quaternion_to_matrix`, which the Gaussian rasterizer calls, is ported so
far; the other conversions of the JAX module wait for their first caller
(ROADMAP A14).
"""

from __future__ import annotations

import torch

__all__ = ["quaternion_to_matrix"]


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(w,x,y,z) [...,4] → [...,3,3]; normalizes q itself."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two = 2.0
    m = torch.stack([
        1 - two * (y * y + z * z), two * (x * y - z * w), two * (x * z + y * w),
        two * (x * y + z * w), 1 - two * (x * x + z * z), two * (y * z - x * w),
        two * (x * z - y * w), two * (y * z + x * w), 1 - two * (x * x + y * y),
    ], -1)
    return m.reshape(q.shape[:-1] + (3, 3))
