"""Port parity: the classic-LoTD models of the JAX package's three example
trainers, at a small width and depth, against the JAX package on the CPU;
and the pieces of the fields that the classic route reaches.

* `LoTDNeuSModel` with no `backend` key (examples/train_neus_object.py's
  default: Dense/Dense/Hash levels, here [8, 16, 32] with a 2^10 hash):
  the `march_occ_multi_upsample` render, unperturbed and with JAX's draws
  replayed, and one step of the example (MSE + 0.03·eikonal through the
  autograd nablas' second order, clip 5, Adam(3e-3)), through
  `tests/test_torch_query_modes.py`'s checks.
* `LoTDNeRFModel` with no `backend` key (examples/train_nerf_synthetic.py:
  `nerf_ray_query_fixed`, MSE, Adam(5e-3)): the render and one step.
* `LoTDForestNeuSModel` with no `backend` key (examples/
  train_forest_street.py: all-Dense levels, `segments` marching, 8
  importance samples): the render and one step (MSE + 0.01·eikonal,
  Adam(1e-2)), held against EAGER JAX (under `jax.jit` XLA's CPU
  compiler fuses the forest march's t: ROADMAP.md §C).
* The three examples' full configurations build in both packages with
  the same encodings, and every state entry crosses the bridge.
* `ScheduledVar` and `get_neus_var_ctrl('scheduled'/'manual')`; the
  embedders `identity`, `sinusoidal` and the annealed window; the
  activations of `get_nonlinearity` and the sine MLP with its SIREN init.

Tolerances (PERF.md §2): the marched renders make discrete choices, so
at least 99% of the rays agree within 1e-4 on rgb and depth (the
normals and the accumulated weight on 97%, as the brick tests); a step's
loss within 1e-4 relative and each gradient within 1e-2 relative L2, and
after the optimizer each parameter within 1e-2·lr of optax's. The fixed
NeRF query makes no discrete choice: its render within 1e-5, its loss
within 1e-5 relative and each gradient within 1e-4 relative L2. The
forest against eager JAX: the render within 1e-4. Embedders and
activations within 1e-6 relative (gelu's tanh form and softplus 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.graphics.nerf_ray_query import nerf_ray_query_fixed as jfixed
from nr3d_lib_tpu.models.fields_forest import LoTDForestNeuSModel as JaxForest
from nr3d_lib_tpu.models.model_base import LoTDNeRFModel as JaxNeRF
from nr3d_lib_tpu.models.model_base import LoTDNeuSModel as JaxNeuS
from nr3d_lib_tpu_torch.bridge import (forest_from_jax_state, from_jax_state,
                                       to_jax_paths)
from nr3d_lib_tpu_torch.graphics.nerf_ray_query import \
    nerf_ray_query_fixed as tfixed
from nr3d_lib_tpu_torch.models.fields_forest import \
    LoTDForestNeuSModel as TorchForest
from nr3d_lib_tpu_torch.models.grid_encodings.lotd import LoTDEncoding
from nr3d_lib_tpu_torch.models.model_base import LoTDNeRFModel as TorchNeRF
from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel as TorchNeuS
from test_torch_query_modes import (ACCEL, MUP, NEUS_TABLE, _check_step,
                                    _flat, _grad_errors, _jax_render,
                                    _mup_uniforms, _occ, _pair, _rays,
                                    _render_close, _replay)

torch.set_num_threads(1)

LOTD = {"lod_res": [8, 16, 32], "lod_n_feats": 2,
        "lod_types": ["Dense", "Dense", "Hash"], "hashmap_size": 2 ** 10}
NEUS = dict(field_cfg={"surface_cfg": {"encoding_cfg": {"lotd_cfg": LOTD},
                                       "decoder_cfg": {"D": 1, "W": 16}},
                       "radiance_cfg": {"D": 2, "W": 16},
                       "var_ctrl_cfg": {"type": "learned",
                                        "init_val": 64.0}},
            accel_cfg=ACCEL, ray_query_cfg=MUP)
N_RENDER = 512


def _t(a):
    return torch.from_numpy(np.array(a))


# -------------------------------------------- the object NeuS (classic)
@pytest.fixture(scope="module")
def neus():
    jm, tm = _pair(JaxNeuS, TorchNeuS, NEUS, NEUS_TABLE, _occ())
    assert isinstance(tm.field.implicit_surface.encoding, LoTDEncoding)
    return jm, tm


@pytest.mark.parametrize("perturb", [False, True])
def test_neus_classic_render_matches_jax(neus, perturb):
    jm, tm = neus
    o, d = _rays(N_RENDER, 1)
    key = jax.random.key(2) if perturb else None
    rj = _jax_render(jm, o, d, key)
    draw = _replay(_mup_uniforms(key, N_RENDER)) if perturb else None
    with torch.no_grad():
        rt, _ = tm.ray_query(tm.ray_test(_t(o), _t(d)), draw=draw)
    _render_close(rt, rj)


def test_neus_classic_example_step_matches_jax(neus):
    """One step of examples/train_neus_object.py: the eikonal term
    differentiates through the autograd nablas (second order through the
    classic gathers)."""
    jm, tm = neus
    o, d = _rays(128, 4)
    key = jax.random.key(5)
    _check_step(jm, tm, o, d, key, _mup_uniforms(key, 128))


# --------------------------------------------------- the fixed NeRF
N_NERF, N_SAMPLES = 128, 32
NERF = dict(field_cfg={"encoding_cfg": {"lotd_cfg": LOTD},
                       "density_decoder_cfg": {"D": 1, "W": 16},
                       "radiance_cfg": {"D": 2, "W": 16}})


@pytest.fixture(scope="module")
def nerf():
    jm, tm = _pair(JaxNeRF, TorchNeRF, NERF, "field/encoding/flattened_params",
                   np.ones((64, 64, 64), np.float32))
    assert not tm.field._frozen_x
    return jm, tm


def test_nerf_classic_fixed_render_and_step_match_jax(nerf):
    """examples/train_nerf_synthetic.py: the perturbed render, one step's
    loss and gradients, and the parameters after Adam(5e-3)."""
    jm, tm = nerf
    o, d = _rays(N_NERF, 6)
    key = jax.random.key(7)
    u = [np.array(jax.random.uniform(key, (N_NERF, N_SAMPLES), jnp.float32))]
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p, oo, dd):
        m = nnx.merge(graphdef, p, rest)
        r, _ = jfixed(m, m.space, m.space.ray_test(oo, dd),
                      n_samples=N_SAMPLES, perturb_key=key)
        return jnp.mean((r["rgb_volume"] - jnp.abs(dd)) ** 2), r

    (jl, rj), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(o), jnp.asarray(d))
    opt = optax.adam(5e-3)
    want = _flat(optax.apply_updates(params, opt.update(
        jg, opt.init(params))[0]))
    tm.zero_grad(set_to_none=True)
    ot, dt = _t(o), _t(d)
    rt, _ = tfixed(tm, tm.space, tm.space.ray_test(ot, dt),
                   n_samples=N_SAMPLES, draw=_replay(u))
    for k in rt:
        np.testing.assert_allclose(rt[k].detach().numpy(), np.asarray(rj[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert float(rt["mask_volume"].detach().mean()) > 0.1
    tl = torch.mean((rt["rgb_volume"] - dt.abs()) ** 2)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    errs = _grad_errors(tm, _flat(jg))
    assert max(errs.values()) <= 1e-4, errs
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    torch.optim.Adam(tm.parameters(), lr=5e-3).step()
    after = to_jax_paths(dict(tm.named_parameters()))
    for k, v in want.items():
        np.testing.assert_allclose(after[k], v, rtol=0, atol=1e-2 * 5e-3,
                                   err_msg=k)
    with torch.no_grad():
        for k, p in tm.named_parameters():
            p.copy_(before[k])
            p.grad = None


# ---------------------------------------------------------- the forest
N_FOREST = 64
FOREST = dict(
    space_cfg={"resolution": (2, 1, 1), "origin": (-1.0, -0.5, -0.5),
               "block_size": 1.0},
    field_cfg={"surface_cfg": {
        "lotd_cfg": {"lod_res": [4, 8], "lod_n_feats": 2,
                     "lod_types": ["Dense", "Dense"]},
        "decoder_cfg": {"D": 1, "W": 16}},
        "radiance_cfg": {"D": 1, "W": 16}},
    n_march_steps=32, march_mode="segments", max_segments=4,
    steps_per_segment=8, n_importance=8)


@pytest.fixture(scope="module")
def forest():
    jm = JaxForest(**FOREST)
    flat = _flat(nnx.state(jm))
    rng = np.random.default_rng(0)
    key = "field/implicit_surface/encoding/flattened_params"
    flat[key] = rng.uniform(-0.1, 0.1, flat[key].shape).astype(np.float32)
    flat["field/var_ctrl/ln_s"] = np.asarray(np.log(64.0) / 10, np.float32)
    grid = flat["accel/occ/val_grid"]
    flat["accel/occ/val_grid"] = (rng.uniform(size=grid.shape) < 0.5
                                  ).astype(np.float32)
    state = nnx.state(jm)
    for k, v in nnx.to_flat_state(state):
        if isinstance(v, nnx.Variable):
            v[...] = jnp.asarray(flat["/".join(map(str, k))])
    nnx.update(jm, state)
    tm = TorchForest(**FOREST, device="cpu")
    tm.load_state_dict(forest_from_jax_state(flat))
    enc = tm.field.implicit_surface.encoding
    assert enc.backend == "xla" and enc.flattened_params.shape == (
        2, enc.meta.n_params)
    return jm, tm


def _forest_draw(key):
    """The forest query's draws in its key split order (the march's, then
    one per upsample round), drawn from JAX's keys at the shapes the port
    asks for (a shape JAX did not draw fails the comparison)."""
    key, km = jax.random.split(key)
    keys = [km]
    for _ in range(2):
        key, ki = jax.random.split(key)
        keys.append(ki)
    it = iter(keys)

    def draw(shape, lo, hi):
        k = next(it)
        if k is km:
            return _t(jax.random.uniform(k, shape, jnp.float32))
        return _t(jax.random.uniform(k, shape, jnp.float32, minval=1e-8,
                                     maxval=1.0 - 1e-8))
    return draw


def _forest_rays(seed: int):
    """Cameras over the corridor looking down it (examples/
    train_forest_street.py `sample_rays`, scaled to two blocks)."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.9, 0.9, N_FOREST),
                  rng.uniform(0.6, 0.9, N_FOREST),
                  rng.uniform(-0.4, 0.4, N_FOREST)], -1)
    t = np.stack([o[:, 0] + rng.normal(size=N_FOREST) * 0.6,
                  np.full(N_FOREST, -0.3), rng.normal(size=N_FOREST) * 0.2],
                 -1)
    d = t - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def forest_jax_step(forest):
    """One eager-JAX step of examples/train_forest_street.py's
    `train_step`, its render kept: compiling the eager primitives is most
    of the time, so the render test reads this evaluation's."""
    jm, _ = forest
    o, d = _forest_rays(10)
    key = jax.random.key(11)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p):
        m = nnx.merge(graphdef, p, rest)
        oo, dd = jnp.asarray(o), jnp.asarray(d)
        rendered, vb = m.ray_query(m.ray_test(oo, dd), key=key)
        eik = jnp.mean((jnp.linalg.norm(vb["nablas_packed"], axis=-1)
                        - 1.0) ** 2)
        loss = jnp.mean((rendered["rgb_volume"] - jnp.abs(dd)) ** 2) \
            + 0.01 * eik
        return loss, (rendered, vb["n_compact"])

    (jl, (rj, n_compact)), jg = jax.value_and_grad(loss_fn,
                                                   has_aux=True)(params)
    opt = optax.adam(1e-2)
    want = _flat(optax.apply_updates(params, opt.update(
        jg, opt.init(params))[0]))
    return o, d, key, jl, _flat(jg), want, rj, int(n_compact)


def test_forest_classic_render_matches_eager_jax(forest, forest_jax_step):
    _, tm = forest
    o, d, key, _, _, _, rj, n_compact = forest_jax_step
    with torch.no_grad():
        rt, vbt = tm.ray_query(tm.ray_test(_t(o), _t(d)),
                               draw=_forest_draw(key))
    assert set(rt) == set(rj)
    for k in rt:
        assert torch.isfinite(rt[k]).all(), k
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), rtol=0,
                                   atol=1e-4, err_msg=k)
    assert int(vbt["n_compact"]) == n_compact > N_FOREST
    assert float(rt["mask_volume"].mean()) > 0.1


def test_forest_classic_step_matches_eager_jax(forest, forest_jax_step):
    """The step's loss, every gradient (the eikonal term through the
    autograd nablas' second order, the block mapping included), and the
    parameters after Adam(1e-2)."""
    _, tm = forest
    o, d, key, jl, jgrads, want, _, _ = forest_jax_step
    tm.zero_grad(set_to_none=True)
    rendered, vb = tm.ray_query(tm.ray_test(_t(o), _t(d)),
                                draw=_forest_draw(key))
    eik = torch.mean((torch.linalg.norm(vb["nablas_packed"], dim=-1)
                      - 1.0) ** 2)
    tl = torch.mean((rendered["rgb_volume"] - torch.abs(_t(d))) ** 2) + \
        0.01 * eik
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    errs = _grad_errors(tm, jgrads)
    assert max(errs.values()) <= 1e-2, errs
    enc = tm.field.implicit_surface.encoding.flattened_params
    assert (enc.grad.abs().sum(-1) > 0).all()          # both blocks
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    torch.optim.Adam(tm.parameters(), lr=1e-2).step()
    after = to_jax_paths(dict(tm.named_parameters()))
    for k, v in want.items():
        np.testing.assert_allclose(after[k], v, rtol=0, atol=1e-2 * 1e-2,
                                   err_msg=k)
    with torch.no_grad():
        for k, p in tm.named_parameters():
            p.copy_(before[k])
            p.grad = None


# ------------------------------ the examples' full configurations
EXAMPLES = {
    # examples/train_neus_object.py:90-110 (no --brick, no --w4)
    "neus_object": (JaxNeuS, TorchNeuS, dict(
        field_cfg={"surface_cfg": {"encoding_cfg": {"lotd_cfg": {
            "lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash", "Hash"],
            "hashmap_size": 2 ** 16}}, "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 2, "W": 64},
            "var_ctrl_cfg": {"type": "learned", "init_val": 64.0}},
        accel_cfg={"resolution": 32, "max_steps_per_ray": 96,
                   "step_size": 2 / 48},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample",
                       "upsample_inv_s_factors": [1.0, 4.0],
                       "n_importance": 12}), from_jax_state),
    # examples/train_nerf_synthetic.py:58-71 (no --brick, no --w4)
    "nerf_synthetic": (JaxNeRF, TorchNeRF, dict(
        field_cfg={"encoding_cfg": {"lotd_cfg": {
            "lod_res": [16, 32, 64], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash"],
            "hashmap_size": 2 ** 14}},
            "density_decoder_cfg": {"D": 1, "W": 64},
            "radiance_cfg": {"D": 2, "W": 64}}), from_jax_state),
    # examples/train_forest_street.py:52-62 (no --brick)
    "forest_street": (JaxForest, TorchForest, dict(
        space_cfg={"resolution": (6, 1, 1), "origin": (-3.0, -0.5, -0.5),
                   "block_size": 1.0},
        field_cfg={"surface_cfg": {
            "lotd_cfg": {"lod_res": [8, 16, 32], "lod_n_feats": 2,
                         "lod_types": ["Dense", "Dense", "Dense"]},
            "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 1, "W": 64}},
        n_march_steps=128, march_mode="segments", max_segments=8,
        steps_per_segment=24, n_importance=8), forest_from_jax_state),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_models_build_without_backend(name):
    jcls, tcls, cfg, bridge = EXAMPLES[name]
    jm, tm = jcls(**cfg), tcls(**cfg, device="cpu")
    flat = _flat(nnx.state(jm))
    tm.load_state_dict(bridge(flat))              # strict: every key
    enc_path = next(k for k in flat if k.endswith("encoding/"
                                                  "flattened_params"))
    te = tm.get_submodule(enc_path.rsplit("/", 1)[0].replace("/", "."))
    assert type(te).__name__ in ("LoTDEncoding", "LoTDForestEncoding")
    je = jm
    for part in enc_path.split("/")[:-1]:
        je = getattr(je, part)
    assert te.meta.level_sizes == je.meta.level_sizes
    assert te.meta.level_res == je.meta.level_res
    assert te.meta.n_params == je.meta.n_params
    np.testing.assert_array_equal(
        te.flattened_params.detach().numpy(), flat[enc_path])


# ------------------------------------------------------- ScheduledVar
def test_scheduled_var_matches_jax():
    from nr3d_lib_tpu.models.fields.neus import ScheduledVar as JSV
    from nr3d_lib_tpu.models.fields.neus import get_neus_var_ctrl as jget
    from nr3d_lib_tpu_torch.models.fields.neus import (ScheduledVar,
                                                       get_neus_var_ctrl)

    cfg = dict(type="logspace", start_val=16.0, stop_val=1024.0,
               start_it=10, stop_it=110)
    jv, tv = JSV(**cfg), ScheduledVar(**cfg, device="cpu")
    for it in (0, 10, 37, 60, 200):
        jv.set_iter(it)
        tv.set_iter(it)
        assert float(tv.inv_s()) == float(jv.inv_s())
    assert list(tv.state_dict()) == ["cur"]
    for t in ("scheduled", "manual"):
        jc, tc = jget(t, value=32.0), get_neus_var_ctrl(t, value=32.0)
        assert isinstance(tc, ScheduledVar)
        assert float(tc.inv_s()) == float(jc.inv_s()) == 32.0
    with pytest.raises(ValueError, match="Unknown var ctrl"):
        get_neus_var_ctrl("bogus")
    # a model with a scheduled inv_s: a stepwise schedule, state bridged
    cfg = {**NEUS, "field_cfg": {**NEUS["field_cfg"],
                                 "var_ctrl_cfg": {"type": "manual",
                                                  "value": 50.0}}}
    jm, tm = JaxNeuS(**cfg), TorchNeuS(**cfg, device="cpu")
    tm.load_state_dict(from_jax_state(_flat(nnx.state(jm))))
    assert tm.has_stepwise_schedules() and jm.has_stepwise_schedules()
    tm.training_before_per_step(3, torch.Generator().manual_seed(0))
    assert float(tm.forward_inv_s()) == 50.0
    assert "ln_s" not in dict(tm.named_parameters())


# --------------------------------------- embedders and activations
EMBED = [{"type": "identity"}, {"type": "none"}, {},
         {"type": "sinusoidal", "n_frequencies": 4},
         {"type": "freq", "n_frequencies": 3, "include_input": False},
         {"type": "frequency", "n_frequencies": 5, "annealed": True}]


@pytest.mark.parametrize("cfg", EMBED, ids=[str(i) for i in
                                             range(len(EMBED))])
def test_embedders_match_jax(cfg):
    from nr3d_lib_tpu.models.embedders import get_embedder as jget
    from nr3d_lib_tpu_torch.models.embedders import get_embedder

    fj, nj = jget(cfg, 3)
    ft, nt = get_embedder(cfg, 3)
    assert nt == nj
    x = np.random.default_rng(12).uniform(-1, 1, (50, 3)).astype(np.float32)
    args = [2.5] if cfg.get("annealed") else []
    yj = np.asarray(fj(jnp.asarray(x), *args))
    yt = ft(_t(x), *args).numpy()
    assert yt.shape == (50, nt)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Unknown embedder"):
        get_embedder({"type": "bogus"})


def test_annealed_freq_encode_matches_jax():
    from nr3d_lib_tpu.models.embedders import annealed_freq_encode as jaf
    from nr3d_lib_tpu_torch.models.embedders import annealed_freq_encode

    x = np.random.default_rng(13).uniform(-1, 1, (40, 2)).astype(np.float32)
    for alpha in (0.0, 1.3, 6.0):
        np.testing.assert_allclose(
            annealed_freq_encode(_t(x), 6, alpha).numpy(),
            np.asarray(jaf(jnp.asarray(x), 6, alpha)), rtol=1e-6, atol=1e-6)


ACTS = ["relu", "softplus", "softplus_raw", "sigmoid", "tanh", "elu", "gelu",
        "silu", "swish", "sine", "squareplus"]


@pytest.mark.parametrize("name", ACTS)
def test_activations_match_jax(name):
    from nr3d_lib_tpu.models.blocks import get_nonlinearity as jget
    from nr3d_lib_tpu_torch.models.blocks import get_nonlinearity

    x = np.random.default_rng(14).uniform(-3, 3, 500).astype(np.float32)
    x[:5] = [0.0, 0.2, -0.2, 0.05, -0.05]       # softplus's ×100 region
    fj, ft = jget(name), get_nonlinearity(name.upper())
    xt = _t(x).requires_grad_(True)
    yt = ft(xt)
    (gt,) = torch.autograd.grad(yt.sum(), xt)
    gj = jax.grad(lambda v: jnp.sum(fj(v)))(jnp.asarray(x))
    tol = 1e-5 if name in ("gelu", "softplus") else 1e-6
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(fj(x)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=tol,
                               atol=tol)
    assert get_nonlinearity(None) is None and get_nonlinearity("none") is None


def test_sine_mlp_matches_jax():
    from nr3d_lib_tpu.models.blocks import MLP as JMLP
    from nr3d_lib_tpu_torch.models.blocks import MLP

    jm = JMLP(3, 4, D=2, W=16, activation="sine", sine_w0=30.0)
    tm = MLP(3, 4, D=2, W=16, activation="sine", sine_w0=30.0, seed=1)
    # the SIREN init's bounds on the port's own draw
    assert float(tm.ws[0].detach().abs().max()) <= 1.0 / 3
    assert float(tm.ws[1].detach().abs().max()) <= np.sqrt(6.0 / 16) / 30.0
    assert float(tm.bs[0].detach().abs().max()) <= 1.0 / np.sqrt(3) and \
        float(tm.bs[0].detach().abs().max()) > 0
    tm.load_state_dict(from_jax_state(_flat(nnx.state(jm))))
    x = np.random.default_rng(15).uniform(-1, 1, (60, 3)).astype(np.float32)
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)
