"""Port parity: the serving render of the brick-LoTD NeuS model
(`LoTDNeuSModel`, query mode march_occ_multi_upsample_compressed) against
the JAX package on the CPU, at a small size, for both brick layouts: F=2
(three levels, f32 table) and F=4 (two levels, bf16-packed). Every test is
a case of each (the `models` fixture is parametrized over F).

Weights cross by the state bridge: the JAX model's nnx state, as numpy,
goes through `bridge.from_jax_state` into the port. The table scale and
ln_s = ln(64)/10 are raised from the defaults so the render is not
trivially empty (mean mask_volume > 0.1 is asserted).

The render makes discrete choices (the `cdf <= u` count, the early-stop
and alpha > 0 keep-mask, the budget cut), so a 1-ulp difference can move a
whole ray. Stages are compared one by one, the final composite from the
same samples tightly, and the whole render by the share of rays whose rgb
and depth agree within 1e-4 (≥ 99%, over 512 rays). Measured on this
configuration: ~99.5% of rays agree within 1e-4; the rest are rays whose
upsampled samples (inv_s up to 1024) move by ~1e-5 because the decoder's
matmuls round differently in the two libraries, plus rare flips of the
keep-mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.model_base import LoTDNeuSModel as JaxModel
from nr3d_lib_tpu_torch.bridge import from_jax_state
from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel as TorchModel

torch.set_num_threads(1)

N_RAYS = 128
LOTD = {2: {"lod_res": [16, 32, 64], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash"]},
        4: {"lod_res": [16, 64], "lod_n_feats": 4,
            "lod_types": ["Dense", "Hash"]}}


def _cfg(n_feats: int) -> dict:
    enc = {"lotd_cfg": {**LOTD[n_feats], "hashmap_size": 2 ** 16},
           "backend": "brick", "hashmap_rows": 64}
    return dict(
        field_cfg={"surface_cfg": {"encoding_cfg": enc,
                                   "decoder_cfg": {"D": 1, "W": 16}},
                   "radiance_cfg": {"D": 2, "W": 16}},
        accel_cfg={"resolution": 16, "max_steps_per_ray": 32,
                   "step_size": 2.0 / 32},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample_compressed",
                       "compression_factor": 0.25,
                       "march_budget_factor": 0.5, "n_importance": 8})


def _flat_state(model) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(model))}


def _jax_field(jm, x, v):
    """The JAX model's joint (sdf, h, nablas, rgb) forward, jitted."""
    graphdef, state = nnx.split(jm)
    return jax.jit(lambda st, xx, vv: nnx.merge(graphdef, st)(xx, vv))(
        state, jnp.asarray(x), jnp.asarray(v))


def _rays(n: int, seed: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module", params=[2, 4], ids=["F2", "F4"])
def models(request):
    cfg = _cfg(request.param)
    jm = JaxModel(**cfg)
    rng = np.random.default_rng(0)
    flat = _flat_state(jm)
    key = "field/implicit_surface/encoding/flattened_params"
    flat[key] = rng.uniform(-0.1, 0.1, flat[key].shape).astype(np.float32)
    flat["field/var_ctrl/ln_s"] = np.asarray(np.log(64.0) / 10.0, np.float32)
    flat["accel/occ/val_grid"] = \
        (rng.uniform(size=(16, 16, 16)) < 0.5).astype(np.float32)
    state = nnx.state(jm)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(jm, state)
    tm = TorchModel(**cfg, device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    assert tm.field.implicit_surface.encoding.n_feats == request.param
    return jm, tm, flat


def test_bridge_round_trip(models):
    jm, tm, flat = models
    sd = tm.state_dict()
    assert set(sd) == {k.replace("/", ".") for k in flat}
    for k, v in flat.items():
        got = sd[k.replace("/", ".")].numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v)
    with pytest.raises(ValueError, match="float64"):
        from_jax_state({"space/aabb": np.zeros((2, 3))})


def test_field_matches_jax(models):
    jm, tm, _ = models
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    v = rng.standard_normal((512, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    oj = _jax_field(jm, x, v)
    with torch.no_grad():
        ot = tm(torch.from_numpy(x), torch.from_numpy(v))
    for k, rtol, atol in (("sdf", 1e-5, 1e-6), ("h", 1e-5, 1e-6),
                          ("nablas", 1e-4, 1e-5), ("rgb", 1e-5, 1e-6)):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_upsample_rounds_matches_jax(models):
    from nr3d_lib_tpu.graphics.neus_ray_query import _upsample_rounds as jup
    from nr3d_lib_tpu_torch.graphics.neus_ray_query import \
        _upsample_rounds as tup

    _, tm, _ = models
    o, d = _rays(N_RAYS, 2)
    with torch.no_grad():
        rt = tm.ray_test(torch.from_numpy(o), torch.from_numpy(d))
        t, _, mask = tm.accel.ray_march(rt["rays_o"], rt["rays_d"],
                                        rt["near"], rt["far"])
    far = rt["far"]

    def sphere(xp, lib):
        return lib.sqrt(lib.sum(xp * xp, -1)) - 0.6

    tj, vj = jax.jit(lambda *a: jup(lambda xx: sphere(xx, jnp), *a, 64.0,
                                    (1.0, 4.0, 16.0), 8, None))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t.numpy()),
        jnp.asarray(mask.numpy()), jnp.asarray(far.numpy()))
    tt, vt = tup(lambda xx: sphere(xx, torch), torch.from_numpy(o),
                 torch.from_numpy(d), t, mask, far, 64.0, (1.0, 4.0, 16.0), 8)
    assert tt.shape == (N_RAYS, 32 + 3 * 8)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-5)


def test_final_composite_from_same_samples(models):
    from nr3d_lib_tpu.graphics import nerf as jn
    from nr3d_lib_tpu.graphics import neus as jneus
    from nr3d_lib_tpu_torch.graphics import nerf as tn
    from nr3d_lib_tpu_torch.graphics import neus as tneus

    jm, tm, _ = models
    o, d = _rays(N_RAYS, 3)
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0.5, 3.0, (N_RAYS, 10)), -1).astype(np.float32)
    valid = rng.uniform(size=(N_RAYS, 10)) < 0.8
    x = (o[:, None] + d[:, None] * t[..., None]).reshape(-1, 3)
    v = np.broadcast_to(d[:, None], (N_RAYS, 10, 3)).reshape(-1, 3)

    def composite(lib_n, lib_neus, where, out, inv_s, sum_):
        sdf = where(valid, out["sdf"].reshape(N_RAYS, 10), 1e4)
        alpha = where(valid, lib_neus.neus_ray_sdf_to_alpha(
            sdf, inv_s, append_cdf_1=True), 0.0)
        vw = lib_n.ray_alpha_to_vw(alpha)
        rgb = sum_(vw[..., None] * out["rgb"].reshape(N_RAYS, 10, 3), -2)
        return vw, rgb

    oj = _jax_field(jm, x, v)
    vwj, rgbj = composite(jn, jneus, jnp.where, oj, jm.forward_inv_s(),
                          jnp.sum)
    with torch.no_grad():
        ot = tm(torch.from_numpy(x), torch.from_numpy(v))
        vt = torch.from_numpy(valid)
        vwt, rgbt = composite(
            tn, tneus,
            lambda c, a, b: torch.where(torch.from_numpy(np.asarray(c)), a,
                                        torch.as_tensor(b)),
            ot, tm.forward_inv_s(), torch.sum)
    assert vt.any()
    np.testing.assert_allclose(vwt.numpy(), np.asarray(vwj), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(rgbt.numpy(), np.asarray(rgbj), rtol=0,
                               atol=1e-5)


def test_whole_render_share_of_rays(models):
    jm, tm, _ = models
    n = 4 * N_RAYS
    o, d = _rays(n, 5)
    graphdef, state = nnx.split(jm)

    @jax.jit
    def render(st, oo, dd):
        m = nnx.merge(graphdef, st)
        rendered, vb = m.ray_query(m.ray_test(oo, dd))
        return rendered, vb["n_compact"]

    rj, ncj = render(state, jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        rt, vbt = tm.ray_query(tm.ray_test(torch.from_numpy(o),
                                           torch.from_numpy(d)))
    for k in ("rgb_volume", "depth_volume", "mask_volume", "normals_volume"):
        assert torch.isfinite(rt[k]).all(), k
    assert float(rt["mask_volume"].mean()) > 0.1      # parity is not vacuous
    ok = np.ones(n, bool)
    for k in ("rgb_volume", "depth_volume"):
        err = np.abs(rt[k].numpy() - np.asarray(rj[k])).reshape(n, -1)
        ok &= err.max(-1) <= 1e-4
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(int(vbt["n_compact"]) - int(ncj)) <= 0.01 * int(ncj)


def test_populate_matches_jax(models):
    jm, tm, flat = models
    cfg = _cfg(tm.field.implicit_surface.encoding.n_feats)
    jm2 = JaxModel(**cfg)
    nnx.update(jm2, nnx.state(jm))
    jm2.populate()
    tm2 = TorchModel(**cfg, device="cpu")
    tm2.load_state_dict(tm.state_dict())
    tm2.populate()
    np.testing.assert_allclose(tm2.accel.occ.val_grid.numpy(),
                               np.asarray(jm2.accel.occ.val_grid[...]),
                               rtol=1e-4, atol=1e-6)


def test_entry_points_default_to_cuda_and_render_sphere_trace(models):
    _, tm, _ = models
    cfg = _cfg(tm.field.implicit_surface.encoding.n_feats)
    if torch.cuda.is_available():
        assert TorchModel(**cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchModel(**cfg)
    # sphere_trace renders on the same weights (its parity is in
    # test_torch_query_modes.py); an unknown mode raises as in JAX
    tm2 = TorchModel(**{**cfg, "ray_query_cfg": {"query_mode": "sphere_trace"}},
                     device="cpu")
    tm2.load_state_dict(tm.state_dict())
    o, d = (torch.from_numpy(a) for a in _rays(16, 30))
    with torch.no_grad():
        r2, vb2 = tm2.ray_query(tm2.ray_test(o, d))
    assert all(bool(torch.isfinite(v).all()) for v in r2.values())
    assert "depth_surface" in r2 and 0 < vb2["trace_iters"] <= 64
    tm2.ray_query_cfg = {"query_mode": "bogus"}
    with pytest.raises(ValueError, match="Unknown query_mode: bogus"):
        tm2.ray_query({})
