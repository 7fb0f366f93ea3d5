"""Port parity: `models/attributes.py` (every class, `lift`/`proj`, the
attribute utilities), the state bridge's `attribute_from_jax`, and the
rest of `graphics/cameras.py` (projection, the OpenCV and fisheye
distortions and their inverses, frustum culling, view normalization,
pose interpolation and the camera paths) against the JAX package on the
CPU.

Each port attribute is built by the bridge from the JAX attribute's
fields. Float32 inputs (the conftest turns on x64 for JAX). Values within
1e-6 absolute or 1e-5 relative (pixels: 1e-4 absolute); culling flags
exact; gradients within 1e-5 relative L2 of `jax.grad`, for
`TransformExpSE3` at θ = 0 (the refinement's start, where (θ − sin θ) and
(1 − cos θ) cancel) and at θ = 0.1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nr3d_lib_tpu.graphics import cameras as JC
from nr3d_lib_tpu.models import attributes as JA
from nr3d_lib_tpu_torch.bridge import attribute_from_jax
from nr3d_lib_tpu_torch.graphics import cameras as TC
from nr3d_lib_tpu_torch.models import attributes as TA


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-6, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _fields(ja) -> dict:
    return {f.name: (v if v is None or isinstance(v, int) else np.asarray(v))
            for f in dataclasses.fields(ja) for v in [getattr(ja, f.name)]}


def _bridge(ja, **kw):
    return attribute_from_jax(type(ja).__name__, _fields(ja), device="cpu",
                              **kw)


def _f32(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _pts(n=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


# ------------------------------------------------------------ rotations
def _rotations():
    rng = np.random.default_rng(1)
    return [JA.RotationQuaternion(_f32(_quats(16, 2))),
            JA.RotationAxisAngle(_f32(rng.normal(size=(16, 3)))),
            JA.Rotation6D(_f32(rng.normal(size=(16, 6)))),
            JA.RotationMat3x3(_f32(np.asarray(JA.RotationQuaternion(
                _f32(_quats(16, 3))).mat_3x3())))]


@pytest.mark.parametrize("i", range(4), ids=["quat", "axis_angle", "6d",
                                             "mat3x3"])
def test_rotations(i):
    ja = _rotations()[i]
    ta = _bridge(ja)
    assert type(ta).__name__ == type(ja).__name__
    p = _pts()
    _close(ta.mat_3x3(), ja.mat_3x3())
    _close(ta.rotate(_t(p)), ja.rotate(_f32(p)))
    _close(ta.inv_rotate(_t(p)), ja.inv_rotate(_f32(p)))


def test_quaternion_interp_and_from_matrix():
    a, b = (JA.RotationQuaternion(_f32(_quats(8, s))) for s in (4, 5))
    ta, tb = _bridge(a), _bridge(b)
    _close(ta.interp1d(tb, 0.3).q, a.interp1d(b, 0.3).q)
    m = np.asarray(a.mat_3x3())
    _close(TA.RotationQuaternion.from_matrix(_t(m)).q,
           JA.RotationQuaternion.from_matrix(_f32(m)).q)


# ------------------------------------------------------------ transforms
def _transforms():
    rng = np.random.default_rng(6)
    rt = JA.TransformRT(_f32(_quats(8, 7)), _f32(rng.normal(size=(8, 3))))
    w = rng.normal(size=(8, 3))
    w = w / np.linalg.norm(w, axis=-1, keepdims=True)
    return [rt, JA.TransformMat4x4(_f32(np.asarray(rt.mat_4x4()))),
            JA.TransformExpSE3(_f32(w), _f32(rng.normal(size=(8, 3))),
                               _f32(rng.uniform(-2, 2, 8)))]


@pytest.mark.parametrize("i", range(3), ids=["rt", "mat4x4", "exp_se3"])
def test_transforms(i):
    ja = _transforms()[i]
    ta = _bridge(ja)
    p = _pts(8)
    for name in ("mat_3x4", "mat_4x4"):
        _close(getattr(ta, name)(), getattr(ja, name)())
    _close(ta.transform(_t(p)), ja.transform(_f32(p)))
    _close(ta.rotate(_t(p)), ja.rotate(_f32(p)))
    if hasattr(ja, "inv"):
        _close(ta.inv().mat_4x4(), ja.inv().mat_4x4())
        _close(ta.inv().transform(ta.transform(_t(p))), p, atol=1e-5)
    if hasattr(ja, "to_rt"):
        got, want = ta.to_rt(), ja.to_rt()
        _close(got.trans, want.trans)
        _close(got.mat_3x4(), want.mat_3x4())
    if hasattr(ja, "interp1d"):
        b = JA.TransformRT(_f32(_quats(8, 8)), _f32(_pts(8, 9)))
        _close(ta.interp1d(_bridge(b), 0.4).mat_4x4(),
               ja.interp1d(b, 0.4).mat_4x4())
        m = np.asarray(ja.mat_4x4())
        _close(TA.TransformRT.from_mat4x4(_t(m)).mat_4x4(),
               JA.TransformRT.from_mat4x4(_f32(m)).mat_4x4())


def test_exp_se3_identity():
    _close(TA.TransformExpSE3.identity((2,), device="cpu").mat_4x4(),
           np.broadcast_to(np.eye(4), (2, 4, 4)))


@pytest.mark.parametrize("theta", [0.0, 0.1])
def test_exp_se3_gradients(theta):
    """The pose-refinement loss of the JAX package's own test (a point
    cloud aligned to a target) and `jax.grad` in (w, v, θ): at θ = 0 only
    θ has a gradient (sin 0 = 0, V(0) = 0), at 0.1 all three."""
    rng = np.random.default_rng(10)
    gt = JA.TransformRT(_f32(_quats(1, 11)[0]), _f32([0.1, -0.2, 0.05]))
    pts = _pts(64, 12)
    target = np.asarray(gt.transform(_f32(pts)), np.float32)
    w = rng.normal(size=3)
    w = (w / np.linalg.norm(w)).astype(np.float32)
    v = rng.normal(size=3).astype(np.float32) * 0.1
    th = np.float32(theta)

    def jloss(ww, vv, tt):
        return jnp.mean((JA.TransformExpSE3(ww, vv, tt).transform(
            _f32(pts)) - _f32(target)) ** 2)

    lj, gj = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        _f32(w), _f32(v), _f32(th))
    ta = attribute_from_jax("TransformExpSE3", {"w": w, "v": v, "theta": th},
                            device="cpu", requires_grad=True)
    lt = torch.mean((ta.transform(_t(pts)) - _t(target)) ** 2)
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    for got, want in zip(ta.parameters(), gj):
        want = np.asarray(want)
        assert np.isfinite(got.grad.numpy()).all()
        err = np.linalg.norm(got.grad.numpy() - want)
        assert err <= 1e-5 * max(np.linalg.norm(want), 1e-12) + 1e-9, \
            (err, want)
    if theta == 0.0:
        assert float(ta.theta.grad) != 0.0 and \
            float(ta.w.grad.abs().max()) == 0.0


def test_scale_segment():
    s = JA.Scale(_f32([[1.0, 2.0, 0.5]]))
    _close(_bridge(s).apply(_t(_pts(4))), s.apply(_f32(_pts(4))))
    _close(_bridge(s).ratio3d(), s.ratio3d())
    seg = JA.Segment(_f32([0.0, 2.0, 5.0]), _f32([3.0, 4.0, 6.0]))
    t = np.asarray([2.0, 3.0, 5.5], np.float32)
    assert (_bridge(seg).valid(_t(t)).numpy() ==
            np.asarray(seg.valid(_f32(t)))).all()
    _close(_bridge(seg).length(), seg.length())


# ------------------------------------------------------------ intrinsics
def _cams():
    f, c = _f32(100.0), _f32(64.0)
    return {
        "pinhole": JA.PinholeCameraIntrinsics(f, _f32(110.0), c, c, 128, 128),
        "mat_hw": JA.PinholeCameraMatHW(_f32(
            [[100.0, 0.0, 64.0], [0.0, 110.0, 60.0], [0.0, 0.0, 1.0]]),
            128, 128),
        "hwf": JA.PinholeCameraHWF(f, c, c, 128, 128),
        "hwf_ratio": JA.PinholeCameraHWFRatio(_f32(100.0 / 128),
                                              _f32(110.0 / 128), c, c,
                                              128, 128),
        "hwf_exp": JA.PinholeCameraHWFExp(_f32(np.log(100.0)),
                                          _f32(np.log(110.0)), c, c,
                                          128, 128),
        "opencv": JA.OpenCVCameraIntrinsics(
            f, f, c, c, 128, 128,
            dist=_f32([0.1, -0.05, 0.001, -0.002, 0.01])),
        "fisheye": JA.FisheyeCameraIntrinsics(
            f, f, c, c, 128, 128, dist=_f32([0.05, -0.01, 0.002, -0.001])),
        "ortho": JA.OrthoCameraIntrinsics(f, f, c, c, 128, 128),
    }


@pytest.mark.parametrize("name", ["pinhole", "mat_hw", "hwf", "hwf_ratio",
                                  "hwf_exp", "opencv", "fisheye", "ortho"])
def test_intrinsics_lift_proj(name):
    ja = _cams()[name]
    ta = _bridge(ja)
    assert (ta.H, ta.W) == (128, 128)
    uv = np.asarray([[20.0, 30.0], [64.0, 64.0], [100.0, 90.0],
                     [5.0, 120.0]], np.float32)
    depth = np.asarray([1.0, 2.5, 4.0, 0.7], np.float32)
    if name != "ortho":                   # it has no (fx, fy) in either
        _close(ta.mat_3x3(), ja.mat_3x3())
    for d in (None, depth):
        _close(ta.lift(_t(uv), None if d is None else _t(d)),
               ja.lift(_f32(uv), None if d is None else _f32(d)))
    x = np.asarray(ja.lift(_f32(uv), _f32(depth)), np.float32)
    (uv_t, z_t), (uv_j, z_j) = ta.proj(_t(x)), ja.proj(_f32(x))
    _close(uv_t, uv_j, atol=1e-4)
    _close(z_t, z_j)
    _close(uv_t, uv, atol=1e-2)                        # the round trip
    if hasattr(ja, "downscale"):
        _close(ta.downscale(2.0).mat_3x3(), ja.downscale(2.0).mat_3x3())
        assert ta.downscale(2.0).H == ja.downscale(2.0).H == 64


def test_intrinsics_from_mat_and_gradient():
    m = np.asarray([[90.0, 0, 60.0], [0, 95.0, 62.0], [0, 0, 1]], np.float32)
    _close(TA.PinholeCameraIntrinsics.from_mat(_t(m), 120, 128).mat_3x3(),
           JA.PinholeCameraIntrinsics.from_mat(_f32(m), 120, 128).mat_3x3())
    uv_obs = np.asarray([[30.0, 40.0]], np.float32)

    def jloss(logf):
        cam = JA.PinholeCameraHWFExp(logf, logf, _f32(64.0), _f32(64.0),
                                     128, 128)
        x = cam.lift(_f32([[32.0, 40.0]]), _f32([2.0]))
        uv, _ = cam.proj(x + _f32([0.01, 0.0, 0.0]))
        return jnp.sum((uv - _f32(uv_obs)) ** 2)

    gj = float(jax.grad(jloss)(_f32(4.6)))
    logf = torch.tensor(4.6, requires_grad=True)
    cam = TA.PinholeCameraHWFExp(logf, logf, torch.tensor(64.0),
                                 torch.tensor(64.0), 128, 128)
    x = cam.lift(torch.tensor([[32.0, 40.0]]), torch.tensor([2.0]))
    uv, _ = cam.proj(x + torch.tensor([0.01, 0.0, 0.0]))
    torch.sum((uv - _t(uv_obs)) ** 2).backward()
    assert abs(float(logf.grad) - gj) <= 1e-5 * abs(gj)


# -------------------------------------------------------- attr utilities
def test_attr_utilities():
    qs = [JA.RotationQuaternion(_f32([1.0, 0, 0, 0])),
          JA.RotationQuaternion(_f32([np.cos(np.pi / 4), 0, 0,
                                      np.sin(np.pi / 4)]))]
    tq = [_bridge(q) for q in qs]
    jb, tb = JA.attr_stack(qs), TA.attr_stack(tq)
    _close(tb.q, jb.q)
    _close(TA.attr_index(tb, 1).q, JA.attr_index(jb, 1).q)
    _close(TA.attr_concat([tb, tb]).q, JA.attr_concat([jb, jb]).q)
    _close(TA.attr_interp1d(tq[0], tq[1], 0.5).q,
           JA.attr_interp1d(qs[0], qs[1], 0.5).q)
    ja = {"pose": JA.TransformRT(qs[0].q, _f32([0.0, 0, 0])),
          "t": _f32(0.0), "scale": JA.Scale(_f32([1.0, 1, 1]))}
    jb2 = {"pose": JA.TransformRT(qs[1].q, _f32([2.0, 0, 0])),
           "t": _f32(1.0), "scale": JA.Scale(_f32([3.0, 1, 1]))}

    def port(d):
        return {"pose": _bridge(d["pose"]), "t": _t(d["t"]),
                "scale": _bridge(d["scale"])}

    m_j = JA.attr_interp1d(ja, jb2, 0.5)
    m_t = TA.attr_interp1d(port(ja), port(jb2), 0.5)
    _close(m_t["t"], m_j["t"])
    _close(m_t["pose"].mat_4x4(), m_j["pose"].mat_4x4())
    _close(m_t["scale"].s, m_j["scale"].s)
    cams = [_cams()["opencv"]] * 3
    st_t = TA.attr_stack([_bridge(c) for c in cams])
    st_j = JA.attr_stack(cams)
    assert st_t.H == 128 and st_t.dist.shape == (3, 5)
    _close(st_t.mat_3x3(), st_j.mat_3x3())
    _close(TA.attr_index(st_t, 2).dist, JA.attr_index(st_j, 2).dist)
    assert [p.shape for p in st_t.parameters()] == \
        [(3,), (3,), (3,), (3,), (3, 5)]


def test_bridge_refusals():
    with pytest.raises(ValueError):
        attribute_from_jax("Scale", {"s": np.ones(3)}, device="cpu")
    with pytest.raises(KeyError):
        attribute_from_jax("attr_stack", {}, device="cpu")
    with pytest.raises(TypeError):
        attribute_from_jax("Scale", {"q": np.ones(3, np.float32)},
                           device="cpu")
    t = attribute_from_jax("TransformRT", _fields(_transforms()[0]),
                           device="cpu", requires_grad=True)
    assert all(p.requires_grad and p.is_leaf for p in t.parameters())


# ---------------------------------------------------------- camera maths
def test_projection_and_distortions():
    rng = np.random.default_rng(13)
    intr = np.asarray([[100.0, 0.3, 64.0], [0, 110.0, 60.0], [0, 0, 1]],
                      np.float32)
    x = (rng.normal(size=(20, 3)) + [0, 0, 4]).astype(np.float32)
    for got, want in zip(TC.pinhole_project(_t(x), _t(intr)),
                         JC.pinhole_project(_f32(x), _f32(intr))):
        _close(got, want)
    xn = rng.uniform(-0.6, 0.6, (64, 2)).astype(np.float32)
    for dist in (np.asarray([0.1, -0.05, 0.001, -0.002], np.float32),
                 np.asarray([0.1, -0.05, 0.001, -0.002, 0.01, 0.02, -0.01,
                             0.003], np.float32)):
        xd = np.asarray(JC.opencv_distort(_f32(xn), _f32(dist)), np.float32)
        _close(TC.opencv_distort(_t(xn), _t(dist)), xd)
        _close(TC.opencv_undistort(_t(xd), _t(dist)),
               JC.opencv_undistort(_f32(xd), _f32(dist)))
        _close(TC.opencv_undistort(_t(xd), _t(dist), iters=20), xn,
               atol=1e-4)
    fd = np.asarray([0.08, -0.02, 0.003, -0.001], np.float32)
    xn[0] = 0.0                                    # the r = 0 branch
    xd = np.asarray(JC.fisheye_distort(_f32(xn), _f32(fd)), np.float32)
    _close(TC.fisheye_distort(_t(xn), _t(fd)), xd)
    _close(TC.fisheye_undistort(_t(xd), _t(fd)),
           JC.fisheye_undistort(_f32(xd), _f32(fd)))
    _close(TC.fisheye_undistort(_t(xd), _t(fd)), xn, atol=1e-5)


def test_frustum_culling():
    """The JAX package's cases (dead centre, behind, aside, beyond far, a
    box holding the frustum, an edge) and a batch of eight poses."""
    intr = np.asarray([[100.0, 0, 64.0], [0, 100.0, 64.0], [0, 0, 1]],
                      np.float32)
    c2w = np.asarray(JC.look_at([0, 0, -4.0], [0, 0, 0]), np.float32)
    boxes = [([0, 0, 0], 0.5), ([0, 0, -6.0], 0.5), ([50.0, 0, 0], 0.5),
             ([0, 0, 10.0], 0.5), ([0, 0, 200.0], 0.5), ([0, 0, 0], 30.0),
             ([2.6, 0, 0], 0.5)]
    want = [True, False, False, True, False, True, True]
    for (c, h), w in zip(boxes, want):
        aabb = np.asarray([np.subtract(c, h), np.add(c, h)], np.float32)
        got = TC.frustum_culling_aabb(_t(intr), _t(c2w), (128, 128),
                                      _t(aabb))
        assert bool(got) == bool(JC.frustum_culling_aabb(
            _f32(intr), _f32(c2w), (128, 128), _f32(aabb))) == w
    rng = np.random.default_rng(14)
    eyes = rng.normal(size=(8, 3)) * 4
    c2ws = np.stack([np.asarray(JC.look_at(e, rng.normal(size=3)),
                                np.float32) for e in eyes])
    aabb = np.asarray([[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]], np.float32)
    got = TC.frustum_culling_aabb(_t(intr), _t(c2ws), (96, 128), _t(aabb))
    want = JC.frustum_culling_aabb(_f32(intr), _f32(c2ws), (96, 128),
                                   _f32(aabb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_normalize_views_and_interp():
    rng = np.random.default_rng(15)
    c2ws = np.stack([np.asarray(JC.look_at(e, [0, 0, 0]), np.float32)
                     for e in rng.normal(size=(6, 3)) * 3 + 1.0])
    for got, want in zip(TC.normalize_views(_t(c2ws), 2.0),
                         JC.normalize_views(_f32(c2ws), 2.0)):
        _close(got, want)
    for a in (0.0, 0.25, 0.8):
        _close(TC.interp_poses(_t(c2ws[0]), _t(c2ws[1]), a),
               JC.interp_poses(_f32(c2ws[0]), _f32(c2ws[1]), a))


def test_camera_paths():
    np.testing.assert_array_equal(
        TC.smoothed_motion_interpolation(1.3, 17, 0.25),
        JC.smoothed_motion_interpolation(1.3, 17, 0.25))
    centers = np.asarray([[2.0, 0.3, 0.1], [1.5, 0.5, 1.2], [0.4, 0.2, 2.1]])
    _close(TC.path_small_circle(centers, 9, device="cpu"),
           JC.path_small_circle(centers, 9), atol=1e-5)
    _close(TC.path_spherical_spiral(centers, 11, device="cpu"),
           JC.path_spherical_spiral(centers, 11), atol=1e-5)
    keys = np.asarray(JC.spherical_camera_path(4, 2.5), np.float32)
    _close(TC.path_interpolation(_t(keys), 10),
           JC.path_interpolation(_f32(keys), 10), atol=1e-5)
