"""Port parity: the LoTD NeRF (`LoTDNeRFModel` over the F=2 brick
encoding, and over the bf16-packed F=4 one: the
experiments/bench_render.py `main(w4=True)` layout) against the JAX
package on the CPU, at a small size (three F=2 levels or two F=4 levels
with a 64-row hash, decoder and radiance width 16, a 16³ grid, 32 march
steps, 256 rays). The model's tests are cases of both layouts (ids
`march_occ`, `march_occ_compressed` for F=2, `…-F4` for F=4).

Weights cross by the state bridge; the table is raised to ±0.1 and half
the occupancy grid is set from a numpy seed, so the renders are not empty
(mean mask_volume > 0.1 is asserted). Both query modes are compared ray by
ray, unperturbed and with the JAX package's march uniforms handed to the
port through `draw`, and the compressed render's loss and every
parameter's gradient are compared as in a NeRF train step.

Tolerances: the NeRF render makes no choice that a last-ulp difference can
flip except the compressed mode's `alpha > 0` and transmittance cuts,
which sit far from their thresholds here, so every ray's rgb, depth and
mask must agree within 1e-5 (float32 sums through two small MLPs and a
scan in another order), and `n_compact` must be equal. The gradients
compare to 1e-4 in relative L2 (sums of many products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.model_base import LoTDNeRFModel as JaxModel
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.models.model_base import LoTDNeRFModel as TorchModel

torch.set_num_threads(1)

N_RAYS = 256
N_STEPS = 32
LOTD = {2: {"lod_res": [8, 16, 32], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash"]},
        4: {"lod_res": [16, 64], "lod_n_feats": 4,
            "lod_types": ["Dense", "Hash"]}}
ACCEL = {"resolution": 16, "max_steps_per_ray": N_STEPS,
         "step_size": 2.0 / N_STEPS}
MODES = {"march_occ": {"query_mode": "march_occ"},
         "march_occ_compressed": {"query_mode": "march_occ_compressed",
                                  "compression_factor": 0.25}}


def _cfg(mode, n_feats=2):
    enc = {"lotd_cfg": {**LOTD[n_feats], "hashmap_size": 2 ** 15},
           "backend": "brick", "hashmap_rows": 64}
    field = {"encoding_cfg": enc, "density_decoder_cfg": {"D": 1, "W": 16},
             "radiance_cfg": {"D": 2, "W": 16}}
    return dict(field_cfg=field, accel_cfg=ACCEL, ray_query_cfg=MODES[mode])


def _flat_state(model) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(model))}


def _rays(n: int, seed: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


CASES = [(mode, f) for f in (2, 4) for mode in sorted(MODES)]


@pytest.fixture(scope="module", params=CASES,
                ids=[m if f == 2 else f"{m}-F4" for m, f in CASES])
def models(request):
    mode, n_feats = request.param
    jm = JaxModel(**_cfg(mode, n_feats))
    jm.populate()
    rng = np.random.default_rng(0)
    flat = _flat_state(jm)
    key = "field/encoding/flattened_params"
    flat[key] = rng.uniform(-0.1, 0.1, flat[key].shape).astype(np.float32)
    flat["accel/occ/val_grid"] = \
        (rng.uniform(size=(16, 16, 16)) < 0.5).astype(np.float32)
    state = nnx.state(jm)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(jm, state)
    tm = TorchModel(**_cfg(mode, n_feats), device="cpu")
    tm.populate()
    tm.load_state_dict(from_jax_state(flat))
    return mode, jm, tm, n_feats


def _jax_render(jm, o, d, key=None):
    graphdef, state = nnx.split(jm)

    @jax.jit
    def render(st, oo, dd):
        m = nnx.merge(graphdef, st)
        rendered, vb = m.ray_query(m.ray_test(oo, dd), key=key)
        return rendered, vb.get("n_compact")

    return render(state, jnp.asarray(o), jnp.asarray(d))


def _replay(us):
    it = iter(us)

    def draw(shape, lo, hi):
        u = next(it)
        assert tuple(u.shape) == tuple(shape) and (lo, hi) == (0.0, 1.0)
        return torch.from_numpy(u)
    return draw


@pytest.mark.parametrize("perturb", [False, True])
def test_render_matches_jax(models, perturb):
    mode, jm, tm, n_feats = models
    o, d = _rays(N_RAYS, 1)
    key = jax.random.key(3) if perturb else None
    rj, ncj = _jax_render(jm, o, d, key)
    draw = _replay([np.array(jax.random.uniform(
        key, (N_RAYS, N_STEPS), jnp.float32))]) if perturb else None
    with torch.no_grad():
        rt, vbt = tm.ray_query(tm.ray_test(torch.from_numpy(o),
                                           torch.from_numpy(d)), draw=draw)
    assert set(rt) == set(rj)
    for k in ("rgb_volume", "depth_volume", "mask_volume"):
        assert torch.isfinite(rt[k]).all(), k
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert float(rt["mask_volume"].mean()) > 0.1      # parity is not vacuous
    if mode == "march_occ_compressed":
        assert int(vbt["n_compact"]) == int(ncj) > 0
        assert vbt["valid"].shape == (N_RAYS, N_STEPS // 4 // 2)


def test_render_grads_match_jax(models):
    """MSE(rgb, |d|) of a perturbed render, differentiated into every
    parameter: the density path through the frozen-x encode (dL/dtable
    only), the radiance path through the decoder's h."""
    mode, jm, tm, n_feats = models
    o, d = _rays(N_RAYS, 2)
    key = jax.random.key(4)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p, oo, dd):
        m = nnx.merge(graphdef, p, rest)
        rendered, _ = m.ray_query(m.ray_test(oo, dd), key=key)
        return jnp.mean((rendered["rgb_volume"] - jnp.abs(dd)) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params, jnp.asarray(o),
                                                   jnp.asarray(d))
    jg = {"/".join(str(p) for p in k): np.asarray(v[...])
          for k, v in nnx.to_flat_state(jg)}
    u = np.array(jax.random.uniform(key, (N_RAYS, N_STEPS), jnp.float32))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    tm.zero_grad(set_to_none=True)
    rendered, _ = tm.ray_query(tm.ray_test(ot, dt), draw=_replay([u]))
    tl = torch.mean((rendered["rgb_volume"] - dt.abs()) ** 2)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(jg)
    errs = {k: float(np.linalg.norm(got[k] - jg[k]) /
                     max(np.linalg.norm(jg[k]), 1e-12)) for k in got}
    assert max(errs.values()) <= 1e-4, errs
    assert np.abs(got["field/encoding/flattened_params"]).max() > 0


def test_training_hooks_and_modes(models):
    mode, jm, tm, n_feats = models
    assert tm.lifecycle_update_every == 16
    before = tm.accel.occ.val_grid.clone()
    g = torch.Generator().manual_seed(0)
    tm2 = TorchModel(**_cfg(mode, n_feats), device="cpu")
    tm2.load_state_dict(tm.state_dict())
    tm2.training_before_per_step(5, g)            # off the interval: no-op
    assert torch.equal(tm2.accel.occ.val_grid, before)
    tm2.training_before_per_step(16, g)           # the EMA update
    assert int(tm2.accel.occ.it) == 1
    assert not torch.equal(tm2.accel.occ.val_grid, before)
    # populate keeps the initial all-occupied grid, as JAX's init(key, None)
    tm3 = TorchModel(**_cfg(mode, n_feats), device="cpu")
    tm3.populate()
    assert bool((tm3.accel.occ.val_grid == 1.0).all())
    # the third NeRF mode renders on the same weights (its parity is in
    # test_torch_query_modes.py); an unknown mode raises as in JAX
    tm4 = TorchModel(**{**_cfg(mode, n_feats), "ray_query_cfg": {
        "query_mode": "march_occ_multi_upsample_compressed"}}, device="cpu")
    tm4.load_state_dict(tm.state_dict())
    o, d = (torch.from_numpy(a) for a in _rays(16, 30))
    with torch.no_grad():
        r4, _ = tm4.ray_query(tm4.ray_test(o, d))
    assert all(bool(torch.isfinite(v).all()) for v in r4.values())
    tm4.ray_query_cfg = {"query_mode": "bogus"}
    with pytest.raises(ValueError, match="Unknown query_mode: bogus"):
        tm4.ray_query({})


def test_trunc_exp_matches_jax():
    from nr3d_lib_tpu.models.fields.nerf import trunc_exp as jte
    from nr3d_lib_tpu_torch.models.fields.nerf import trunc_exp as tte

    x = np.asarray([-40.0, -15.5, -15.0, -3.0, 0.0, 2.5, 15.0, 16.0, 80.0],
                   np.float32)
    g = np.linspace(0.5, 2.0, x.size).astype(np.float32)
    yj, vjp = jax.vjp(jte, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tte(xt)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6)
    # outside the clip the gradient is g·exp(±15), not 0
    assert float(gt[0]) == pytest.approx(float(g[0]) * np.exp(-15.0),
                                         rel=1e-6)
    assert float(gt[-1]) == pytest.approx(float(g[-1]) * np.exp(15.0),
                                          rel=1e-6)


def test_tau_to_alpha_matches_jax():
    from nr3d_lib_tpu.graphics.nerf import tau_to_alpha as jt
    from nr3d_lib_tpu_torch.graphics.nerf import tau_to_alpha as tt

    tau = np.random.default_rng(5).uniform(0, 5, 64).astype(np.float32)
    np.testing.assert_allclose(tt(torch.from_numpy(tau)).numpy(),
                               np.asarray(jt(jnp.asarray(tau))), rtol=1e-6,
                               atol=1e-7)


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TorchModel(**_cfg("march_occ")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchModel(**_cfg("march_occ"))
