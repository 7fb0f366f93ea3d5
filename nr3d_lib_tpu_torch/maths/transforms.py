"""Rotation representations: quaternion, axis-angle, 6D and matrix.

Port of nr3d_lib_tpu/maths/transforms.py, with the same conventions:
quaternions (w, x, y, z), unit norm; matrices act on column vectors.
`matrix_to_quaternion` computes all four Shepperd candidates and keeps the
one of the largest component (the first on a tie, as `jnp.argmax`), so
its gradient at a branch point is the JAX version's: `safe_sqrt` clamps
with `torch.maximum`, which splits the gradient at a tie as
`jnp.maximum` does.
"""

from __future__ import annotations

import torch

__all__ = [
    "quaternion_to_matrix", "matrix_to_quaternion",
    "axis_angle_to_matrix", "matrix_to_axis_angle",
    "axis_angle_to_quaternion", "quaternion_to_axis_angle",
    "rotation_6d_to_matrix", "matrix_to_rotation_6d",
    "quaternion_multiply", "quaternion_invert", "quaternion_apply",
]


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


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.maximum(x, torch.full_like(x, 1e-12)))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """[...,3,3] → (w,x,y,z), unit norm."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = _safe_sqrt(1 + tr) / 2
    qx = _safe_sqrt(1 + m00 - m11 - m22) / 2
    qy = _safe_sqrt(1 - m00 + m11 - m22) / 2
    qz = _safe_sqrt(1 - m00 - m11 + m22) / 2
    c0 = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                      (m10 - m01) / (4 * qw)], -1)
    c1 = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                      (m02 + m20) / (4 * qx)], -1)
    c2 = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                      (m12 + m21) / (4 * qy)], -1)
    c3 = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                      (m12 + m21) / (4 * qz), qz], -1)
    best = torch.argmax(torch.stack([qw, qx, qy, qz], -1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], -2)                    # [...,4,4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    half = angle * 0.5
    small = angle < 1e-6
    ratio = torch.where(small, 0.5 - angle ** 2 / 48,
                        torch.sin(half) / torch.clamp(angle, min=1e-12))
    return torch.cat([torch.cos(half), aa * ratio], -1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    q = q * torch.sign(q[..., :1] + 1e-12)                # the w ≥ 0 branch
    norm_v = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm_v, q[..., :1])
    small = norm_v < 1e-6
    scale = torch.where(small, torch.full_like(angle, 2.0),
                        angle / torch.clamp(norm_v, min=1e-12))
    return q[..., 1:] * scale


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(aa))


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(m))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al.'s 6D → matrix by Gram–Schmidt; the rows are b1, b2,
    b1 × b2."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=1e-8)
    a2p = a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.norm(a2p, dim=-1, keepdim=True),
                           min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], -2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quaternion_apply(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    p = torch.cat([torch.zeros_like(pts[..., :1]), pts], -1)
    out = quaternion_multiply(quaternion_multiply(q, p), quaternion_invert(q))
    return out[..., 1:]
