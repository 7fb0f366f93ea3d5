"""Scene attributes with batch prefixes: rotations, rigid transforms,
scales, camera intrinsics and validity segments (port of
nr3d_lib_tpu/models/attributes.py).

The JAX attributes are flax pytrees. Here each is a small dataclass whose
fields are tensors (the leaves) or ints (an image size, not a leaf). A
leaf may be a tensor that requires its gradient, which is how pose or
intrinsics refinement optimizes one: `attr.parameters()` lists the leaves
for a torch optimizer. `attr_index`, `attr_stack`, `attr_concat` and
`attr_interp1d` map over the leaves of any attribute or nested container
(dicts, lists, tuples) of attributes.

`TransformExpSE3` is the refinement parameterization: a unit screw axis
(w, v) and an angle θ, the identity at (w, v, θ) = 0. Its Rodrigues and V
matrices are written as the JAX version writes them; at θ = 0 their
derivatives hold no cancelling terms, so the gradients there need no
series.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.graphics.cameras import (
    fisheye_distort, fisheye_undistort, opencv_distort, opencv_undistort,
    pinhole_lift, pinhole_project)
from nr3d_lib_tpu_torch.maths.slerp import slerp
from nr3d_lib_tpu_torch.maths.transforms import (
    axis_angle_to_quaternion, matrix_to_quaternion, quaternion_to_matrix,
    rotation_6d_to_matrix)

__all__ = [
    "RotationQuaternion", "RotationAxisAngle", "Rotation6D", "RotationMat3x3",
    "TransformRT", "TransformMat4x4", "TransformExpSE3", "Scale",
    "PinholeCameraIntrinsics", "PinholeCameraMatHW", "PinholeCameraHWF",
    "PinholeCameraHWFRatio",
    "PinholeCameraHWFExp", "OpenCVCameraIntrinsics",
    "FisheyeCameraIntrinsics", "OrthoCameraIntrinsics", "Segment",
    "attr_index", "attr_stack", "attr_concat", "attr_interp1d",
]


class _Attr:
    """The leaves of an attribute dataclass: its tensor fields."""

    def leaves(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def parameters(self) -> List[torch.Tensor]:
        return list(self.leaves().values())


# ------------------------------------------------------------------ SO3 reps
class _RotBase(_Attr):
    def mat_3x3(self) -> torch.Tensor:
        raise NotImplementedError

    def rotate(self, v: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ij,...j->...i", self.mat_3x3(), v)

    def inv_rotate(self, v: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ji,...j->...i", self.mat_3x3(), v)


@dataclasses.dataclass
class RotationQuaternion(_RotBase):
    q: torch.Tensor  # [..., 4] (w, x, y, z)

    def mat_3x3(self) -> torch.Tensor:
        return quaternion_to_matrix(self.q)

    def interp1d(self, other: "RotationQuaternion", alpha
                 ) -> "RotationQuaternion":
        return RotationQuaternion(slerp(self.q, other.q, alpha))

    @classmethod
    def from_matrix(cls, m: torch.Tensor) -> "RotationQuaternion":
        return cls(matrix_to_quaternion(m))


@dataclasses.dataclass
class RotationAxisAngle(_RotBase):
    aa: torch.Tensor  # [..., 3]

    def mat_3x3(self) -> torch.Tensor:
        return quaternion_to_matrix(axis_angle_to_quaternion(self.aa))


@dataclasses.dataclass
class Rotation6D(_RotBase):
    d6: torch.Tensor  # [..., 6]

    def mat_3x3(self) -> torch.Tensor:
        return rotation_6d_to_matrix(self.d6)


@dataclasses.dataclass
class RotationMat3x3(_RotBase):
    m: torch.Tensor  # [..., 3, 3]

    def mat_3x3(self) -> torch.Tensor:
        return self.m


# ------------------------------------------------------------------ SE3 reps
def _bottom_row(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=like.dtype,
                        device=like.device).expand(like.shape[:-2] + (1, 4))


class _TransformBase(_Attr):
    def mat_3x4(self) -> torch.Tensor:
        raise NotImplementedError

    def mat_4x4(self) -> torch.Tensor:
        m34 = self.mat_3x4()
        return torch.cat([m34, _bottom_row(m34)], -2)

    def transform(self, pts: torch.Tensor) -> torch.Tensor:
        m = self.mat_3x4()
        return torch.einsum("...ij,...j->...i", m[..., :3], pts) + m[..., 3]

    def rotate(self, v: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ij,...j->...i", self.mat_3x4()[..., :3], v)


@dataclasses.dataclass
class TransformRT(_TransformBase):
    """A rotation (quaternion) and a translation."""

    rot: torch.Tensor    # [..., 4]
    trans: torch.Tensor  # [..., 3]

    def mat_3x4(self) -> torch.Tensor:
        return torch.cat([quaternion_to_matrix(self.rot),
                          self.trans[..., None]], -1)

    def inv(self) -> "TransformRT":
        sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=self.rot.dtype,
                            device=self.rot.device)
        t_inv = -torch.einsum("...ji,...j->...i",
                              quaternion_to_matrix(self.rot), self.trans)
        return TransformRT(self.rot * sign, t_inv)

    def interp1d(self, other: "TransformRT", alpha) -> "TransformRT":
        """slerp of the rotations, lerp of the translations."""
        return TransformRT(slerp(self.rot, other.rot, alpha),
                           self.trans * (1 - alpha) + other.trans * alpha)

    @classmethod
    def from_mat4x4(cls, m: torch.Tensor) -> "TransformRT":
        return cls(matrix_to_quaternion(m[..., :3, :3]), m[..., :3, 3])


@dataclasses.dataclass
class TransformMat4x4(_TransformBase):
    m: torch.Tensor  # [..., 4, 4]

    def mat_3x4(self) -> torch.Tensor:
        return self.m[..., :3, :]

    def mat_4x4(self) -> torch.Tensor:
        return self.m

    def inv(self) -> "TransformMat4x4":
        r_t = self.m[..., :3, :3].transpose(-1, -2)
        t_inv = -torch.einsum("...ij,...j->...i", r_t, self.m[..., :3, 3])
        top = torch.cat([r_t, t_inv[..., None]], -1)
        return TransformMat4x4(torch.cat([top, _bottom_row(top)], -2))


@dataclasses.dataclass
class TransformExpSE3(_TransformBase):
    """The se(3) exponential map of a unit screw axis (w, v) and an angle
    θ; the identity at (w, v, θ) = 0."""

    w: torch.Tensor      # [..., 3] rotation axis
    v: torch.Tensor      # [..., 3] translation direction
    theta: torch.Tensor  # [...]

    @classmethod
    def identity(cls, shape=(), device=None) -> "TransformExpSE3":
        dev = resolve_device(device)
        return cls(torch.zeros(shape + (3,), device=dev),
                   torch.zeros(shape + (3,), device=dev),
                   torch.zeros(shape, device=dev))

    def _pieces(self) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.w
        zeros = torch.zeros_like(w[..., 0])
        w_ss = torch.stack([
            torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], zeros], -1)], -2)
        w_ss2 = w_ss @ w_ss
        th = self.theta[..., None, None]
        eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(
            w.shape[:-1] + (3, 3))
        rot = eye + torch.sin(th) * w_ss + (1 - torch.cos(th)) * w_ss2
        V = eye * th + (1 - torch.cos(th)) * w_ss + (th - torch.sin(th)) * \
            w_ss2
        return rot, torch.einsum("...ij,...j->...i", V, self.v)

    def mat_3x4(self) -> torch.Tensor:
        rot, trans = self._pieces()
        return torch.cat([rot, trans[..., None]], -1)

    def to_rt(self) -> TransformRT:
        rot, trans = self._pieces()
        return TransformRT(matrix_to_quaternion(rot), trans)


@dataclasses.dataclass
class Scale(_Attr):
    """A per-axis scale."""

    s: torch.Tensor  # [..., 3]

    def ratio3d(self) -> torch.Tensor:
        return self.s

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return pts * self.s


# ---------------------------------------------------------------- intrinsics
class _IntrBase(_Attr):
    def mat_3x3(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx], -1),
            torch.stack([z, self.fy, self.cy], -1),
            torch.stack([z, z, o], -1)], -2)

    def lift(self, uv: torch.Tensor, depth: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        return pinhole_lift(uv, self.mat_3x3(), depth)

    def proj(self, x_cam: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        return pinhole_project(x_cam, self.mat_3x3())


@dataclasses.dataclass
class PinholeCameraIntrinsics(_IntrBase):
    """(fx, fy, cx, cy) and the image size."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    H: int = 0
    W: int = 0

    @classmethod
    def from_mat(cls, mat: torch.Tensor, H: int = 0, W: int = 0):
        return cls(mat[..., 0, 0], mat[..., 1, 1], mat[..., 0, 2],
                   mat[..., 1, 2], H, W)

    def downscale(self, factor: float) -> "PinholeCameraIntrinsics":
        f = 1.0 / factor
        return PinholeCameraIntrinsics(self.fx * f, self.fy * f, self.cx * f,
                                       self.cy * f, int(self.H // factor),
                                       int(self.W // factor))


@dataclasses.dataclass
class PinholeCameraMatHW(_IntrBase):
    """The full 3×3 matrix as the parameter (skew included); fx, fy, cx,
    cy are views of it."""

    mat: torch.Tensor  # [..., 3, 3]
    H: int = 0
    W: int = 0

    def mat_3x3(self) -> torch.Tensor:
        return self.mat

    @property
    def fx(self):
        return self.mat[..., 0, 0]

    @property
    def fy(self):
        return self.mat[..., 1, 1]

    @property
    def cx(self):
        return self.mat[..., 0, 2]

    @property
    def cy(self):
        return self.mat[..., 1, 2]

    def downscale(self, factor: float) -> "PinholeCameraMatHW":
        s = torch.tensor([1.0 / factor, 1.0 / factor, 1.0],
                         dtype=self.mat.dtype, device=self.mat.device)
        return PinholeCameraMatHW(self.mat * s[:, None],
                                  int(self.H // factor),
                                  int(self.W // factor))


@dataclasses.dataclass
class PinholeCameraHWF(_IntrBase):
    """One focal length for both axes: fx = fy = f."""

    f: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    H: int = 0
    W: int = 0

    @property
    def fx(self):
        return self.f

    @property
    def fy(self):
        return self.f


@dataclasses.dataclass
class PinholeCameraHWFRatio(_IntrBase):
    """Focal lengths as ratios of the image size: fx = rx·W, fy = ry·H."""

    rx: torch.Tensor
    ry: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    H: int = 0
    W: int = 0

    @property
    def fx(self):
        return self.rx * self.W

    @property
    def fy(self):
        return self.ry * self.H


@dataclasses.dataclass
class PinholeCameraHWFExp(_IntrBase):
    """Log focal lengths: fx = exp(log_fx), which keeps a refined focal
    positive."""

    log_fx: torch.Tensor
    log_fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    H: int = 0
    W: int = 0

    @property
    def fx(self):
        return torch.exp(self.log_fx)

    @property
    def fy(self):
        return torch.exp(self.log_fy)


def _normalized(intr, uv: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - intr.cx) / intr.fx,
                        (uv[..., 1] - intr.cy) / intr.fy], -1)


def _lifted(xn: torch.Tensor, uv: torch.Tensor,
            depth: Optional[torch.Tensor]) -> torch.Tensor:
    z = torch.ones_like(uv[..., 0]) if depth is None else depth
    return torch.cat([xn * z[..., None], z[..., None]], -1)


def _projected(intr, x_cam: torch.Tensor, distort
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    z = x_cam[..., 2]
    xd = distort(x_cam[..., :2] / z[..., None], intr.dist)
    return torch.stack([xd[..., 0] * intr.fx + intr.cx,
                        xd[..., 1] * intr.fy + intr.cy], -1), z


@dataclasses.dataclass
class OpenCVCameraIntrinsics(PinholeCameraIntrinsics):
    """Pinhole with the OpenCV distortion, dist [..., ≥4] = (k1, k2, p1,
    p2[, k3, …]); `lift` undistorts by fixed-point steps."""

    dist: Optional[torch.Tensor] = None

    def proj(self, x_cam: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _projected(self, x_cam, opencv_distort)

    def lift(self, uv: torch.Tensor, depth: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        return _lifted(opencv_undistort(_normalized(self, uv), self.dist),
                       uv, depth)


@dataclasses.dataclass
class FisheyeCameraIntrinsics(PinholeCameraIntrinsics):
    """Pinhole with the equidistant fisheye, dist [..., 4]; `lift`
    undistorts by Newton steps."""

    dist: Optional[torch.Tensor] = None

    def proj(self, x_cam: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _projected(self, x_cam, fisheye_distort)

    def lift(self, uv: torch.Tensor, depth: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        return _lifted(fisheye_undistort(_normalized(self, uv), self.dist),
                       uv, depth)


@dataclasses.dataclass
class OrthoCameraIntrinsics(_IntrBase):
    """Orthographic: u = sx·x + cx, v = sy·y + cy."""

    sx: torch.Tensor
    sy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    H: int = 0
    W: int = 0

    def lift(self, uv: torch.Tensor, depth: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        z = torch.ones_like(uv[..., 0]) if depth is None else depth
        return torch.stack([(uv[..., 0] - self.cx) / self.sx,
                            (uv[..., 1] - self.cy) / self.sy, z], -1)

    def proj(self, x_cam: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.stack([x_cam[..., 0] * self.sx + self.cx,
                            x_cam[..., 1] * self.sy + self.cy], -1), \
            x_cam[..., 2]


# ----------------------------------------------------------- attr utilities
def _map(fn, *attrs):
    """fn over the tensor leaves of same-structured attributes (nested in
    dicts, lists and tuples); anything else is taken from the first."""
    a = attrs[0]
    if isinstance(a, torch.Tensor):
        return fn(*attrs)
    if isinstance(a, dict):
        return {k: _map(fn, *(x[k] for x in attrs)) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_map(fn, *xs) for xs in zip(*attrs))
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _map(fn, *(getattr(x, f.name) for x in attrs))
            for f in dataclasses.fields(a)
            if getattr(a, f.name) is not None and
            not isinstance(getattr(a, f.name), (int, float, str))})
    return a


def attr_index(attr, idx):
    """attr[idx] over the leading batch axis of every leaf."""
    return _map(lambda leaf: leaf[idx], attr)


def attr_stack(attrs, axis: int = 0):
    """Stack same-type attributes along a new batch axis."""
    return _map(lambda *leaves: torch.stack(leaves, axis), *attrs)


def attr_concat(attrs, axis: int = 0):
    """Concatenate same-type attributes along an existing batch axis."""
    return _map(lambda *leaves: torch.cat(leaves, axis), *attrs)


def attr_interp1d(a, b, alpha):
    """Interpolate two same-type attributes: a class's own `interp1d`
    (slerp for rotations and transforms), else a lerp of each leaf;
    containers recurse."""
    if hasattr(a, "interp1d"):
        return a.interp1d(b, alpha)
    if isinstance(a, dict):
        return {k: attr_interp1d(a[k], b[k], alpha) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(attr_interp1d(x, y, alpha) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor) or not dataclasses.is_dataclass(a):
        return a * (1 - alpha) + b * alpha
    return dataclasses.replace(a, **{
        k: attr_interp1d(leaf, getattr(b, k), alpha)
        for k, leaf in a.leaves().items()})


# ------------------------------------------------------------------ segment
@dataclasses.dataclass
class Segment(_Attr):
    """Validity interval per entity: it exists for frame indices in
    [start, stop)."""

    start: torch.Tensor
    stop: torch.Tensor

    def valid(self, t: torch.Tensor) -> torch.Tensor:
        return (t >= self.start) & (t < self.stop)

    def length(self) -> torch.Tensor:
        return self.stop - self.start
