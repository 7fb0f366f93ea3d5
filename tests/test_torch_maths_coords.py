"""Port parity: `maths/transforms.py`, `slerp.py`, `common.py`,
`depth_completion.py`, `knn.dist_to_nn3_mean` and `coordinates.py`
against the JAX package on the CPU.

Float32 inputs from a numpy seed (the conftest turns on x64 for JAX).
Values within 1e-6 absolute or 1e-5 relative; gradients within 1e-5
relative L2 of `jax.grad`. `matrix_to_quaternion` is held at its branch
points too: matrices whose dominant quaternion component is each of w, x,
y, z, and exact ties between two components (the first wins in both, and
the gradient follows that branch). The depth completion is bitwise (max
and min filters are exact).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nr3d_lib_tpu import coordinates as jcoord
from nr3d_lib_tpu.maths import common as jcommon
from nr3d_lib_tpu.maths import knn as jknn
from nr3d_lib_tpu.maths import transforms as jtr
from nr3d_lib_tpu_torch import coordinates as tcoord
from nr3d_lib_tpu_torch.maths import common as tcommon
from nr3d_lib_tpu_torch.maths import knn as tknn
from nr3d_lib_tpu_torch.maths import transforms as ttr

# the packages' `__init__` binds these names to the functions
jdc, tdc, jslerp, tslerp = (
    importlib.import_module(f"{pkg}.maths.{mod}")
    for mod in ("depth_completion", "slerp")
    for pkg in ("nr3d_lib_tpu", "nr3d_lib_tpu_torch"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _grad_close(jf, tf, *inputs, tol=1e-5):
    """jax.grad and torch autograd of sum(f(x)·w) in every input."""
    w = np.random.default_rng(99).uniform(-1, 1, np.shape(
        jf(*(jnp.asarray(a) for a in inputs)))).astype(np.float32)
    gj = jax.grad(lambda *a: jnp.sum(jf(*a) * w),
                  argnums=tuple(range(len(inputs))))(
        *(jnp.asarray(a) for a in inputs))
    xs = [_t(a).requires_grad_(True) for a in inputs]
    torch.sum(tf(*xs) * _t(w)).backward()
    for x, g in zip(xs, gj):
        g = np.asarray(g)
        err = np.linalg.norm(x.grad.numpy() - g)
        assert err <= tol * max(np.linalg.norm(g), 1e-12), (err, g)


# ---------------------------------------------------------------- transforms
def _branch_matrices():
    """Rotations whose largest Shepperd component is w, x, y and z, and
    ties: the identity (w), 180° about x (x), about y, about z, and 120°
    about (1,1,1) (w = x = y = z = ½)."""
    qs = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
          [0.5, 0.5, 0.5, 0.5], [np.sqrt(0.5), np.sqrt(0.5), 0, 0],
          [0, np.sqrt(0.5), np.sqrt(0.5), 0], [0.1, 0.2, 0.9, 0.3]]
    q = np.asarray(qs, np.float32)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jtr.quaternion_to_matrix(jnp.asarray(q, jnp.float32)),
                      np.float32)


CONVERSIONS = [
    ("quaternion_to_matrix", lambda n: _quats(n, 1)),
    ("matrix_to_quaternion", lambda n: np.asarray(jtr.quaternion_to_matrix(
        jnp.asarray(_quats(n, 2))), np.float32)),
    ("axis_angle_to_matrix", lambda n: np.random.default_rng(3).normal(
        size=(n, 3)).astype(np.float32)),
    ("axis_angle_to_quaternion", lambda n: np.random.default_rng(4).normal(
        size=(n, 3)).astype(np.float32)),
    ("quaternion_to_axis_angle", lambda n: _quats(n, 5)),
    ("matrix_to_axis_angle", lambda n: np.asarray(jtr.quaternion_to_matrix(
        jnp.asarray(_quats(n, 6))), np.float32)),
    ("rotation_6d_to_matrix", lambda n: np.random.default_rng(7).normal(
        size=(n, 6)).astype(np.float32)),
    ("matrix_to_rotation_6d", lambda n: np.random.default_rng(8).normal(
        size=(n, 3, 3)).astype(np.float32)),
    ("quaternion_invert", lambda n: _quats(n, 9)),
]


@pytest.mark.parametrize("name, make", CONVERSIONS,
                         ids=[c[0] for c in CONVERSIONS])
def test_conversions(name, make):
    x = make(64)
    _close(getattr(ttr, name)(_t(x)), getattr(jtr, name)(jnp.asarray(x)))
    _grad_close(getattr(jtr, name), getattr(ttr, name), x)


def test_quaternion_products():
    a, b = _quats(32, 10), _quats(32, 11)
    p = np.random.default_rng(12).normal(size=(32, 3)).astype(np.float32)
    _close(ttr.quaternion_multiply(_t(a), _t(b)),
           jtr.quaternion_multiply(jnp.asarray(a), jnp.asarray(b)))
    _close(ttr.quaternion_apply(_t(a), _t(p)),
           jtr.quaternion_apply(jnp.asarray(a), jnp.asarray(p)))
    _grad_close(jtr.quaternion_multiply, ttr.quaternion_multiply, a, b)
    _grad_close(jtr.quaternion_apply, ttr.quaternion_apply, a, p)


def test_matrix_to_quaternion_branch_points():
    m = _branch_matrices()
    q_t = ttr.matrix_to_quaternion(_t(m))
    q_j = jtr.matrix_to_quaternion(jnp.asarray(m))
    _close(q_t, q_j)
    _grad_close(jtr.matrix_to_quaternion, ttr.matrix_to_quaternion, m)
    # a tie: the same candidate on both sides (w and x at √½)
    assert abs(float(q_t[5, 0]) - float(q_t[5, 1])) < 1e-6


def test_round_trips():
    q = _quats(128, 13)
    back = ttr.matrix_to_quaternion(ttr.quaternion_to_matrix(_t(q)))
    sign = torch.sign(torch.sum(back * _t(q), -1, keepdim=True))
    _close(back * sign, q, atol=1e-5)
    aa = np.random.default_rng(14).uniform(-2, 2, (128, 3)).astype(
        np.float32)
    _close(ttr.matrix_to_axis_angle(ttr.axis_angle_to_matrix(_t(aa))), aa,
           atol=1e-4)


# ------------------------------------------------------ slerp, common
def test_slerp():
    a, b = _quats(16, 15), _quats(16, 16)
    b[0] = a[0]                                 # the near branch
    b[1] = -a[1]                                # the shorter arc
    for t in (0.3, np.random.default_rng(17).uniform(size=16).astype(
            np.float32)):
        _close(tslerp.slerp(_t(a), _t(b), t if np.ndim(t) == 0 else _t(t)),
               jslerp.slerp(jnp.asarray(a), jnp.asarray(b),
                            t if np.ndim(t) == 0 else jnp.asarray(t)))
    _grad_close(lambda x, y: jslerp.slerp(x, y, 0.3),
                lambda x, y: tslerp.slerp(x, y, 0.3), a[2:], b[2:])


def test_common():
    x = np.random.default_rng(18).normal(size=(40,)).astype(np.float32)
    inv_s = np.float32(7.5)
    for name in ("logistic_density", "logistic_cdf"):
        _close(getattr(tcommon, name)(_t(x), float(inv_s)),
               getattr(jcommon, name)(jnp.asarray(x), inv_s))
        _grad_close(lambda a: getattr(jcommon, name)(a, inv_s),
                    lambda a: getattr(tcommon, name)(a, float(inv_s)), x)
    v = np.random.default_rng(19).normal(size=(20, 3)).astype(np.float32)
    v[0] = 0.0
    _close(tcommon.normalize(_t(v)), jcommon.normalize(jnp.asarray(v)))
    _close(tcommon.normalize(_t(v), axis=0),
           jcommon.normalize(jnp.asarray(v), axis=0))
    _grad_close(jcommon.normalize, tcommon.normalize, v[1:])


# ------------------------------------------------------------ coordinates
@pytest.mark.parametrize("name", ["opengl_to_opencv", "opencv_to_opengl",
                                  "waymo_to_opencv", "opencv_to_waymo"])
def test_coordinates(name):
    rng = np.random.default_rng(20)
    m = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    m[:, :3, :3] = np.asarray(jtr.quaternion_to_matrix(
        jnp.asarray(_quats(5, 21))))
    m[:, :3, 3] = rng.normal(size=(5, 3))
    # JAX's change of basis is a float64 numpy matrix: with x64 on, the
    # rotation block would be computed in float64 and cast back
    with jax.enable_x64(False):
        want = np.asarray(getattr(jcoord, name)(jnp.asarray(m)))
    _close(getattr(tcoord, name)(_t(m)), want)
    src, dst = name.split("_to_")
    back = tcoord.convert_pose(getattr(tcoord, name)(_t(m)), dst, src)
    _close(back, m)
    assert tcoord.convert_pose(_t(m), "opencv", "opencv") is not None


# --------------------------------------------------------- depth completion
@pytest.mark.parametrize("kernel, fill", [(5, True), (3, False), (4, True)])
def test_depth_completion_bitwise(kernel, fill):
    rng = np.random.default_rng(22)
    h, w = 48, 64
    d = np.where(rng.uniform(size=(h, w)) < 0.05,
                 rng.uniform(0.05, 120.0, size=(h, w)), 0.0).astype(
        np.float32)
    want = jdc.depth_completion(d, kernel=kernel, fill_remaining=fill)
    got = tdc.depth_completion(_t(d), kernel=kernel, fill_remaining=fill)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(
        tdc.depth_completion(d, kernel=kernel,
                             fill_remaining=fill).numpy(), want)


# --------------------------------------------------------------------- knn
@pytest.mark.parametrize("chunk", [8192, 50])
def test_dist_to_nn3_mean(chunk):
    pts = np.random.default_rng(23).normal(size=(300, 3)).astype(np.float32)
    want = jknn.dist_to_nn3_mean(jnp.asarray(pts))
    got = tknn.dist_to_nn3_mean(_t(pts), chunk=chunk)
    _close(got, want)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    brute = np.sort(d2, -1)[:, 1:4].mean(-1)
    _close(got, brute, atol=1e-6)
