"""Port parity: the static permutohedral fields (`PermutoSDF`,
`PermutoNeuS`, `PermutoNeRF`, F=2 cell backend) against the JAX package on
the CPU, from bridged weights.

Small size: a 3D lattice of res [2, 8, 24] in 64 rows per level (a dense
level and hashed levels that collide), decoder and radiance width 16, a
sphere residual of radius 0.5 on the SDF. Weights cross by the state
bridge (`bridge.from_jax_state`, the JAX nnx state as numpy); the table is
raised to ±0.1 so the features matter. The JAX side runs its XLA route,
the port its plain versions (the CPU route launches no kernel).

Tolerances: values, nablas and rgb are float32 sums in another order
through the decoder's matmuls and the lattice blend (1e-5 relative to the
largest entry); a loss's gradients by parameter path, which for the SDF's
eikonal term run through the nablas' second order, to 1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.fields.nerf import PermutoNeRF as JNeRF
from nr3d_lib_tpu.models.fields.neus import PermutoNeuS as JNeuS
from nr3d_lib_tpu.models.fields.sdf import PermutoSDF as JSDF
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.models.fields.nerf import PermutoNeRF as TNeRF
from nr3d_lib_tpu_torch.models.fields.neus import PermutoNeuS as TNeuS
from nr3d_lib_tpu_torch.models.fields.sdf import PermutoSDF as TSDF
from nr3d_lib_tpu_torch.ops import _build

torch.set_num_threads(1)

N = 600
PERMUTO = {"res_list": [2.0, 8.0, 24.0], "backend": "cell",
           "hashmap_rows": 64}
SDF_CFG = dict(permuto_cfg=PERMUTO, decoder_cfg={"D": 1, "W": 16},
               radius_init=0.5)
FIELDS = {
    "sdf": (JSDF, TSDF, SDF_CFG),
    "neus": (JNeuS, TNeuS, dict(surface_cfg=SDF_CFG,
                                radiance_cfg={"D": 2, "W": 16})),
    "nerf": (JNeRF, TNeRF, dict(permuto_cfg=PERMUTO,
                                density_decoder_cfg={"D": 1, "W": 16},
                                radiance_cfg={"D": 2, "W": 16})),
}


def _flat_state(model) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(model))}


@pytest.fixture(scope="module", params=sorted(FIELDS))
def fields(request):
    """(name, JAX field with a ±0.1 table, its state, the bridged port
    field)."""
    jcls, tcls, cfg = FIELDS[request.param]
    jf = jcls(**cfg)
    flat = _flat_state(jf)
    key = next(k for k in flat if k.endswith("bank/flattened_params"))
    flat[key] = np.random.default_rng(0).uniform(
        -0.1, 0.1, flat[key].shape).astype(np.float32)
    state = nnx.state(jf)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(jf, state)
    tf = tcls(**cfg, device="cpu")
    tf.load_state_dict(from_jax_state(flat))
    return request.param, jf, flat, tf


def _points(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (N, 3)).astype(np.float32)
    x[:50] = np.round(x[:50] * 4.0) / 4.0                # lattice ties
    x[50], x[51] = -1.0, 1.0                             # the box corners
    v = rng.normal(size=(N, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    return x, v


def _close(got, want, rel: float = 1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _jax_out(jf, name, x, v):
    x, v = jnp.asarray(x), jnp.asarray(v)
    if name == "sdf":
        return {**jf.forward_sdf_nablas(x), "sdf_only": jf(x)}
    return jf(x, v)


def _port_out(tf, name, x, v):
    x, v = torch.from_numpy(x), torch.from_numpy(v)
    if name == "sdf":
        return {**tf.forward_sdf_nablas(x), "sdf_only": tf(x)}
    return tf(x, v)


def test_bridge_maps_the_permuto_fields(fields):
    """Every nnx path of the field maps to a port parameter of the same
    shape (strict load), and back: the [rows, 128] table, the decoder,
    the radiance head and ln_s."""
    name, _, flat, tf = fields
    back = to_jax_paths(tf.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    bank = tf.implicit_surface.bank if name == "neus" else tf.bank
    assert bank.flattened_params.shape == (bank.meta.total_rows, 128)
    assert bank.out_features == 6


def test_field_outputs_match_jax(fields):
    """sdf, h and the split nablas (decoder vjp + 0.5 · the bank's
    nablas) of PermutoSDF; (sdf, nablas, rgb) of PermutoNeuS; (sigma, h,
    rgb) of PermutoNeRF."""
    name, jf, _, tf = fields
    x, v = _points(1)
    want = _jax_out(jf, name, x, v)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        got = _port_out(tf, name, x, v)
    assert dict(_build.LAUNCHES) == before              # the CPU route
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k])
    if "nablas" in want:
        assert float(np.abs(np.asarray(want["nablas"])).max()) > 0.1


def _jax_loss(jf, name, x, v):
    graphdef, params, rest = nnx.split(jf, nnx.Param, ...)

    def loss_fn(p):
        m = nnx.merge(graphdef, p, rest)
        if name == "nerf":
            out = m(jnp.asarray(x), jnp.asarray(v))
            return jnp.mean(out["sigma"]) + jnp.mean(out["rgb"] ** 2)
        out = m.forward_sdf_nablas(jnp.asarray(x)) if name == "sdf" else \
            m(jnp.asarray(x), jnp.asarray(v))
        nrm = jnp.linalg.norm(out["nablas"], axis=-1)
        loss = jnp.mean(out["sdf"] ** 2) + 0.1 * jnp.mean((nrm - 1.0) ** 2)
        if name == "neus":
            loss = loss + jnp.mean(out["rgb"] ** 2) + 1e-3 * m.forward_inv_s()
        return loss

    jl, jg = jax.value_and_grad(loss_fn)(params)
    return float(jl), {"/".join(str(p) for p in k): np.asarray(g[...])
                       for k, g in nnx.to_flat_state(jg)}


def _port_loss(tf, name, x, v):
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    if name == "nerf":
        out = tf(xt, vt)
        return torch.mean(out["sigma"]) + torch.mean(out["rgb"] ** 2)
    out = tf.forward_sdf_nablas(xt) if name == "sdf" else tf(xt, vt)
    nrm = torch.linalg.norm(out["nablas"], dim=-1)
    loss = torch.mean(out["sdf"] ** 2) + 0.1 * torch.mean((nrm - 1.0) ** 2)
    if name == "neus":
        loss = loss + torch.mean(out["rgb"] ** 2) + 1e-3 * tf.forward_inv_s()
    return loss


def test_field_gradients_match_jax(fields):
    """A loss's gradients by parameter path: for the SDF and the NeuS an
    eikonal term, whose table gradient runs through the nablas' second
    order, and for the NeuS its rgb and inv_s; for the NeRF the density
    and rgb (the encode's table backward)."""
    name, jf, _, tf = fields
    x, v = _points(2)
    jl, jg = _jax_loss(jf, name, x, v)
    tf.zero_grad(set_to_none=True)
    before = dict(_build.LAUNCHES)
    tl = _port_loss(tf, name, x, v)
    tl.backward()
    assert dict(_build.LAUNCHES) == before
    assert abs(float(tl.detach()) - jl) <= 1e-5 * abs(jl)
    got = to_jax_paths({k: p.grad for k, p in tf.named_parameters()})
    assert set(got) == set(jg)
    errs = {k: float(np.linalg.norm(got[k] - jg[k]) /
                     max(np.linalg.norm(jg[k]), 1e-12)) for k in got}
    assert max(errs.values()) <= 1e-4, errs
    key = next(k for k in got if k.endswith("bank/flattened_params"))
    assert float(np.abs(got[key]).max()) > 0


def test_classic_backend_builds():
    """The JAX default, the classic lattice, builds: a flat table of
    5 levels × 2^17 rows × 2 features (parity in
    test_torch_permuto_lattice.py)."""
    for f in (TSDF(permuto_cfg={"backend": "xla"}, device="cpu"),
              TNeRF(device="cpu")):
        assert f.bank.backend == "xla"
        assert f.bank.flattened_params.shape == (5 * 2 ** 17 * 2,)
        assert f.bank.out_features == 10
