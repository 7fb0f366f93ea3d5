"""Port parity: pose refinement through the NeuS render, against
`jax.grad` through the JAX package's render on the CPU.

The model is a small `--w4` `LoTDNeuSModel` (F=4 brick LoTD, the
default `march_occ_multi_upsample`) from a bridged JAX state
(`test_torch_query_modes.py`'s helpers: tables in ±0.1, a seeded
occupancy grid). The camera is an `OpenCVCameraIntrinsics` (64 × 64,
k1, k2, p1, p2 of order 1e-2); the pose is `TransformExpSE3` ∘
`TransformRT`, the RT a camera at radius 2 looking at the origin turned
by 2° and moved by 0.02, the ExpSE3 the refinement (θ = 0, its start, and
θ = 0.02). 256 pixels are lifted through the undistortion to rays; the
target is JAX's render at the unperturbed pose.

The loss is the MSE of rgb; its value within 1e-4 relative and its
gradients in (w, v, θ) within 1e-2 relative L2 of `jax.grad` (PERF.md
§2's step rule: the render's discrete choices move a few rays whole);
rgb within 1e-4 on at least 99% of the rays. The gradient reaches the
pose through the final query's positions (x = o + t·d with t carried
without gradient, as JAX's stop_gradient) and through the view
directions into the radiance net, which reads the nablas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.graphics.cameras import look_at as jlook_at
from nr3d_lib_tpu.models import attributes as JA
from nr3d_lib_tpu.models.model_base import LoTDNeuSModel as JaxNeuS
from nr3d_lib_tpu_torch.bridge import attribute_from_jax
from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel as TorchNeuS
from test_torch_query_modes import MUP, NEUS_TABLE, _neus_cfg, _occ, _pair

torch.set_num_threads(1)

HW = 64
N_PIX = 256
INTR = dict(fx=np.float32(60.0), fy=np.float32(62.0), cx=np.float32(32.0),
            cy=np.float32(31.0), H=HW, W=HW,
            dist=np.asarray([0.02, -0.01, 0.005, -0.003], np.float32))


def _poses():
    """(the true RT, the perturbed RT) as numpy fields."""
    c2w = jlook_at(np.asarray([0.6, 0.5, -1.85]), np.zeros(3))
    gt = JA.TransformRT.from_mat4x4(jnp.asarray(c2w, jnp.float32))
    ax = np.asarray([0.3, -0.8, 0.5])
    ax = ax / np.linalg.norm(ax)
    half = np.deg2rad(2.0) / 2
    dq = np.concatenate([[np.cos(half)], np.sin(half) * ax])
    from nr3d_lib_tpu.maths.transforms import quaternion_multiply
    rot = np.asarray(quaternion_multiply(jnp.asarray(dq, jnp.float32),
                                         gt.rot), np.float32)
    trans = (np.asarray(gt.trans) + [0.02, 0.0, 0.0]).astype(np.float32)
    return ({"rot": np.asarray(gt.rot, np.float32),
             "trans": np.asarray(gt.trans, np.float32)},
            {"rot": rot, "trans": trans})


def _uv():
    rng = np.random.default_rng(0)
    pix = rng.choice(HW * HW, N_PIX, replace=False)
    return np.stack([pix % HW, pix // HW], -1).astype(np.float32) + 0.5


def _rays(lib, intr, delta, rt, uv):
    """World rays through pixels uv: lift (undistort), rotate by the pose
    delta ∘ rt, normalize."""
    c2w = delta.mat_4x4() @ rt.mat_4x4()
    dirs = intr.lift(uv)
    if lib is jnp:
        d = jnp.einsum("ij,nj->ni", c2w[:3, :3], dirs)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return jnp.broadcast_to(c2w[:3, 3], d.shape), d
    d = torch.einsum("ij,nj->ni", c2w[:3, :3], dirs)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[:3, 3].expand(d.shape), d


def _jax_intr():
    f = {k: (v if isinstance(v, int) else jnp.asarray(v))
         for k, v in INTR.items()}
    return JA.OpenCVCameraIntrinsics(**f)


@pytest.fixture(scope="module")
def setup():
    jm, tm = _pair(JaxNeuS, TorchNeuS, _neus_cfg(4, MUP), NEUS_TABLE, _occ())
    graphdef, state = nnx.split(jm)
    gt, noisy = _poses()
    uv = jnp.asarray(_uv())
    intr = _jax_intr()

    @jax.jit
    def render(st, w, v, th, rot, trans):
        m = nnx.merge(graphdef, st)
        o, d = _rays(jnp, intr, JA.TransformExpSE3(w, v, th),
                     JA.TransformRT(rot, trans), uv)
        return m.ray_query(m.ray_test(o, d))[0]["rgb_volume"]

    zero = jnp.zeros(3, jnp.float32)
    target = np.array(render(state, zero, zero, jnp.float32(0.0),
                             jnp.asarray(gt["rot"]),
                             jnp.asarray(gt["trans"])), np.float32)

    @jax.jit
    def value_and_grad(st, w, v, th):
        def loss(ww, vv, tt):
            rgb = render(st, ww, vv, tt, jnp.asarray(noisy["rot"]),
                         jnp.asarray(noisy["trans"]))
            return jnp.mean((rgb - jnp.asarray(target)) ** 2), rgb
        return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            w, v, th)

    return tm, state, value_and_grad, target, noisy


@pytest.mark.parametrize("theta", [0.0, 0.02])
def test_pose_gradients_match_jax(setup, theta):
    tm, state, value_and_grad, target, noisy = setup
    rng = np.random.default_rng(1)
    w = rng.normal(size=3)
    w = (w / np.linalg.norm(w)).astype(np.float32)
    v = (rng.normal(size=3) * 0.1).astype(np.float32)
    th = np.float32(theta)
    (lj, rgb_j), gj = value_and_grad(state, jnp.asarray(w), jnp.asarray(v),
                                     jnp.asarray(th))

    intr = attribute_from_jax("OpenCVCameraIntrinsics", INTR, device="cpu")
    delta = attribute_from_jax("TransformExpSE3",
                               {"w": w, "v": v, "theta": th}, device="cpu",
                               requires_grad=True)
    rt = attribute_from_jax("TransformRT", noisy, device="cpu")
    for p in tm.parameters():
        p.requires_grad_(False)               # the field is frozen
    try:
        o, d = _rays(torch, intr, delta, rt, torch.from_numpy(_uv()))
        rgb = tm.ray_query(tm.ray_test(o, d))[0]["rgb_volume"]
        lt = torch.mean((rgb - torch.from_numpy(target)) ** 2)
        lt.backward()
    finally:
        for p in tm.parameters():
            p.requires_grad_(True)
    err = np.abs(rgb.detach().numpy() - np.asarray(rgb_j)).max(-1)
    assert float(np.mean(err <= 1e-4)) >= 0.99, float(np.mean(err <= 1e-4))
    assert float(rgb.detach().abs().max()) > 0.0
    assert abs(float(lt.detach()) - float(lj)) <= 1e-4 * abs(float(lj))
    got = np.concatenate([p.grad.numpy().reshape(-1)
                          for p in delta.parameters()])
    want = np.concatenate([np.asarray(g).reshape(-1) for g in gj])
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"θ = {theta}: loss {float(lt.detach()):.6e} / {float(lj):.6e}; "
          f"grad relative L2 {rel:.3e}; port {got}; JAX {want}")
    assert rel <= 1e-2
