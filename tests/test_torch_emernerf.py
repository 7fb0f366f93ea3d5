"""Port parity: EmerNeRF (`EmerNeRFModel`, examples/train_dynamic_scene.py's
model family) and the batched / time-keyed occupancy accels against the
JAX package on the CPU, at a small size: the static classic LoTD at
[4, 8, 16] (Dense, Dense, Hash of 2^9), the dynamic classic 4D lattice at
[4, 8] (2^10 entries a level), EmerNeRF's fixed W=64 decoders, a 8³
accel with 4 time keys, 48 rays of 16 march steps.

Weights cross by the state bridge (`bridge.from_jax_state`); the tables
are raised to ±0.1 so the render is not trivially empty, and a seeded
25% of the static and dynamic cells is occupied. `jax.random` cannot be
reproduced in torch: the march's jitter (`march_steps(perturb_key=key)`,
one [R, S] uniform), the field's training-mode warp noise
(`1.5·uniform(key)`) and the occupancy update's cells and points are drawn
by JAX and handed to the port (`draw`, `noise_u`, `apply_update`). The
JAX model calls its field without a key, so its warp noise is 1 there;
the port's model does the same.

`sample_pts_in_occupied` draws with `jax.random.choice(p=…)`, which torch
cannot replay: the port's draw is held by its law instead — every sample
lies in an occupied cell when some cell is occupied (the weight of an
empty cell is 1e-6 of an occupied one's), and spreads over the whole box
when none is.

Tolerances: the field and the cycle loss are elementwise (outputs within
1e-5 relative with a floor of 1e-6 of the largest entry); the render ray
by ray, at least 99% of rays within 1e-4 on rgb, depth and mask (measured:
all rays within 6e-7 in all three branches); one train step of the
example's loss within 1e-4 relative and each gradient within 1e-2
relative L2 (measured: the same loss, gradients within 6.2e-7). The accels' integers (time keys, slots, masks) exactly; the
marches' t within 1e-6. The JAX render runs under `jax.jit`: it moves no
ray against eager JAX at this size (checked by
`test_render_jit_matches_eager_jax`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.model_families import EmerNeRFModel as JaxModel
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.models.model_families import EmerNeRFModel as \
    TorchModel

torch.set_num_threads(1)

N_RAYS = 48
N_STEPS = 16
N_KEYS = 4
RES = 8
STATIC_LOTD = {"lod_res": [4, 8, 16], "lod_n_feats": 2,
               "lod_types": ["Dense", "Dense", "Hash"],
               "hashmap_size": 2 ** 9}
DYN_PERMUTO = {"res_list": [4.0, 8.0], "n_feats": 2, "log2_hashmap_size": 10}


def _cfg(**field) -> dict:
    return dict(field_cfg={"static_cfg": {"lotd_cfg": STATIC_LOTD},
                           "dynamic_permuto_cfg": DYN_PERMUTO, **field},
                accel_cfg={"resolution": (RES,) * 3}, n_time_keys=N_KEYS,
                n_march_steps=N_STEPS)


CFG = _cfg()
TABLES = ("field/static_encoding/flattened_params",
          "field/dyn_bank/flattened_params")


def _flat_state(model) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(model))}


def _set_state(model, flat) -> None:
    state = nnx.state(model)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(model, state)


def _seeded(cfg=CFG, seed: int = 0):
    """The JAX model with tables in ±0.1 and a seeded 25% occupancy, and
    its state as {path: numpy} (float64 keyframes, from the suite's x64,
    set to their float32 values)."""
    jm = JaxModel(**cfg)
    rng = np.random.default_rng(seed)
    flat = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in _flat_state(jm).items()}
    for key in TABLES:
        if key in flat:
            flat[key] = rng.uniform(-0.1, 0.1, flat[key].shape
                                    ).astype(np.float32)
    for key in ("accel/static/val_grid", "accel/dynamic/occ/val_grid"):
        flat[key] = (rng.uniform(size=flat[key].shape) < 0.25
                     ).astype(np.float32)
    _set_state(jm, flat)
    return jm, flat


@pytest.fixture(scope="module")
def models():
    return _seeded()


def _torch_model(flat, cfg=CFG):
    tm = TorchModel(**cfg, device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    return tm


def _rays(n: int, seed: int):
    """examples/train_dynamic_scene.py's ray distribution, from numpy."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o[:, 1] = np.abs(o[:, 1]) * 0.5 + 0.2
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = rng.uniform(-0.3, 0.3, (n, 3)) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ts = rng.uniform(-1.0, 1.0, n)
    return o.astype(np.float32), d.astype(np.float32), ts.astype(np.float32)


def _tested(model, o, d, ts, lib):
    rt = model.ray_test(lib(o), lib(d))
    rt["ts"] = lib(ts)
    return rt


def _ray_errs(rt, rj, keys) -> np.ndarray:
    err = np.zeros(rt[keys[0]].shape[0])
    for k in keys:
        e = np.abs(rt[k].detach().numpy() - np.asarray(rj[k]))
        err = np.maximum(err, e.reshape(err.shape[0], -1).max(-1))
    return err


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-1) + 1e-7
    assert float(np.abs(got - want).max()) <= tol, \
        (float(np.abs(got - want).max()), tol)


def _jax_draws(occ, key, n):
    """The cells and points `OccGridEmaBatched.step_update` draws."""
    from nr3d_lib_tpu.models.accelerations.occgrid import sample_cells_uniform

    keys = jax.random.split(key, occ.n_batch)
    draws = [sample_cells_uniform(k, occ.resolution, n, jnp.float32)
             for k in keys]
    return (torch.from_numpy(np.stack([np.asarray(a) for a, _ in draws])
                             .astype(np.int64)),
            torch.from_numpy(np.stack([np.asarray(b) for _, b in draws])))


# ------------------------------------------------------------ the bridge
def test_bridge_maps_the_emernerf_paths(models):
    _, flat = models
    tm = _torch_model(flat)
    for path in TABLES + ("accel/static/val_grid", "accel/static/it",
                          "accel/dynamic/occ/val_grid",
                          "accel/dynamic/ts_keyframes", "space/ts_keyframes",
                          "field/flow_mlp/ws/2", "field/shadow_mlp/ws/1"):
        assert path in flat, path
    back = to_jax_paths(tm.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    assert tm.lifecycle_update_every == 1          # as JAX: no interval
    assert not tm.has_stepwise_schedules()


# ------------------------------------------------------------- the field
def _field_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    ts = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    return x, v, ts


def _field_pair(field_cfg: dict, only_dynamic: bool = False):
    from nr3d_lib_tpu.models.fields_dynamic import EmerNeRF as JF
    from nr3d_lib_tpu.models.fields_dynamic import EmerNeRFOnlyDynamic as JD
    from nr3d_lib_tpu_torch.models.fields_dynamic import EmerNeRF as TF
    from nr3d_lib_tpu_torch.models.fields_dynamic import \
        EmerNeRFOnlyDynamic as TD

    cfg = dict(dynamic_permuto_cfg=DYN_PERMUTO, **field_cfg)
    if not only_dynamic:
        cfg["static_cfg"] = {"lotd_cfg": STATIC_LOTD}
    jf = (JD if only_dynamic else JF)(**cfg)
    rng = np.random.default_rng(1)
    flat = _flat_state(jf)
    for k in flat:
        if k.endswith("flattened_params"):
            flat[k] = rng.uniform(-0.1, 0.1, flat[k].shape).astype(np.float32)
    _set_state(jf, flat)
    tf = (TD if only_dynamic else TF)(**cfg, device="cpu")
    tf.load_state_dict(from_jax_state(flat))
    return jf, tf


@pytest.mark.parametrize("agg", [True, False], ids=["agg", "no_agg"])
@pytest.mark.parametrize("only_dynamic", [False, True],
                         ids=["emernerf", "only_dynamic"])
def test_field_matches_jax(agg, only_dynamic):
    jf, tf = _field_pair({"temporal_aggregation": agg}, only_dynamic)
    x, v, ts = _field_inputs(300, 2)
    key = jax.random.key(3)
    graphdef, state = nnx.split(jf)
    call = jax.jit(lambda st, k: nnx.merge(graphdef, st)(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(ts), key=k))
    oj = call(state, key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (300,),
                                                     jnp.float32)))
    with torch.no_grad():
        ot = tf(torch.from_numpy(x), torch.from_numpy(v),
                torch.from_numpy(ts), noise_u=u if agg else None)
    assert set(ot) == set(oj)
    for k in oj:
        _close(ot[k].numpy(), oj[k])
    if agg:                     # no key: the warp noise is 1, as in JAX
        oj1 = call(state, None)
        with torch.no_grad():
            ot1 = tf(torch.from_numpy(x), torch.from_numpy(v),
                     torch.from_numpy(ts))
        _close(ot1["rgb"].numpy(), oj1["rgb"])
        assert not np.allclose(np.asarray(oj1["rgb"]), np.asarray(oj["rgb"]))
    np.testing.assert_allclose(tf.get_weight_reg().detach().numpy(),
                               np.asarray(jf.get_weight_reg()), rtol=1e-6)


def test_field_gradients_match_jax():
    """dL/dparams of a loss over every output of the aggregating field,
    warp noise from JAX's draw."""
    jf, tf = _field_pair({})
    x, v, ts = _field_inputs(200, 4)
    key = jax.random.key(5)
    graphdef, params, rest = nnx.split(jf, nnx.Param, ...)

    def loss(p):
        o = nnx.merge(graphdef, p, rest)(jnp.asarray(x), jnp.asarray(v),
                                         jnp.asarray(ts), key=key)
        return sum(jnp.mean(o[k] ** 2) for k in sorted(o))

    jg = {"/".join(str(p) for p in k): np.asarray(g[...])
          for k, g in nnx.to_flat_state(jax.jit(jax.grad(loss))(params))}
    u = torch.from_numpy(np.array(jax.random.uniform(key, (200,),
                                                     jnp.float32)))
    o = tf(torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(ts),
           noise_u=u)
    sum(torch.mean(o[k] ** 2) for k in sorted(o)).backward()
    got = to_jax_paths({k: p.grad for k, p in tf.named_parameters()})
    assert set(got) == set(jg)
    for k in got:
        err = np.linalg.norm(got[k] - jg[k]) / max(np.linalg.norm(jg[k]),
                                                   1e-12)
        assert err <= 1e-4, (k, err)


def test_cycle_loss_matches_jax():
    from nr3d_lib_tpu.models.fields_dynamic import emernerf_cycle_loss as jl
    from nr3d_lib_tpu_torch.models.fields_dynamic import \
        emernerf_cycle_loss as tl

    rng = np.random.default_rng(6)
    out = {k: rng.normal(size=(50, 3)).astype(np.float32)
           for k in ("flow_fwd", "flow_bwd", "flow_fwd_pred_bwd",
                     "flow_bwd_pred_fwd")}
    mask = (rng.uniform(size=50) < 0.5).astype(np.float32)
    oj = {k: jnp.asarray(v) for k, v in out.items()}
    ot = {k: torch.from_numpy(v) for k, v in out.items()}
    np.testing.assert_allclose(float(tl(ot)), float(jl(oj)), rtol=1e-6)
    np.testing.assert_allclose(float(tl(ot, torch.from_numpy(mask))),
                               float(jl(oj, jnp.asarray(mask))), rtol=1e-6)
    assert float(tl(ot, torch.zeros(50))) == 0.0


# -------------------------------------------------- populate and updates
def test_populate_and_update_match_jax(models):
    """populate's static grid (σ_static at the cell centers) and one EMA
    update of the dynamic grids, from JAX's draws; then the lifecycle's
    update at it = 16 the same way."""
    jm, flat = models
    tm = _torch_model(flat)
    jm2 = JaxModel(**CFG)
    nnx.update(jm2, nnx.state(jm))
    key = jax.random.key(7)
    nnx.jit(lambda m, k: m.populate(k))(jm2, key)
    n = RES ** 3 // 4
    idx, x = _jax_draws(jm2.accel.dynamic.occ, key, n)
    with torch.no_grad():
        tm.accel.static.init_from_net(tm._static_query)
        tm.accel.dynamic.occ.apply_update(idx, x, tm._dyn_query)
    _close(tm.accel.static.val_grid.numpy(),
           jm2.accel.static.val_grid[...])
    _close(tm.accel.dynamic.occ.val_grid.numpy(),
           jm2.accel.dynamic.occ.val_grid[...])
    key2 = jax.random.key(8)
    nnx.jit(lambda m, k: m.training_before_per_step(16, k))(jm2, key2)
    idx, x = _jax_draws(jm2.accel.dynamic.occ, key2, n)
    with torch.no_grad():
        tm.accel.dynamic.occ.apply_update(idx, x, tm._dyn_query)
    _close(tm.accel.dynamic.occ.val_grid.numpy(),
           jm2.accel.dynamic.occ.val_grid[...])


def test_training_hooks(models):
    _, flat = models
    tm = _torch_model(flat)
    before = tm.accel.dynamic.occ.val_grid.clone()
    static = tm.accel.static.val_grid.clone()
    g = torch.Generator().manual_seed(0)
    tm.training_before_per_step(5, g)              # off the interval: no-op
    assert torch.equal(tm.accel.dynamic.occ.val_grid, before)
    tm.training_before_per_step(16, g)
    assert not torch.equal(tm.accel.dynamic.occ.val_grid, before)
    assert torch.equal(tm.accel.static.val_grid, static)
    tm.populate()
    assert not torch.equal(tm.accel.static.val_grid, static)
    tm.training_after_per_step(16)


def test_sample_pts(models):
    _, flat = models
    tm = _torch_model(flat)
    g = torch.Generator().manual_seed(1)
    x, ts = tm.sample_pts_uniform(g, 4000)
    assert x.shape == (4000, 3) and ts.shape == (4000,)
    assert float(x.min()) >= -1.0 and float(x.max()) < 1.0
    assert float(ts.min()) >= -1.0 and float(ts.max()) < 1.0
    x, ts = tm.sample_pts_in_occupied(g, 500)
    assert x.shape == (500, 3) and ts.shape == (500,)
    assert bool(tm._any_occ(x).all())
    with torch.no_grad():                          # empty grids: uniform
        tm.accel.static.val_grid.zero_()
        tm.accel.dynamic.occ.val_grid.zero_()
    x, _ = tm.sample_pts_in_occupied(g, 2000)
    assert not bool(tm._any_occ(x).any())
    assert float(x.min()) < -0.9 and float(x.max()) > 0.9


# ------------------------------------------------------------ the render
def _jax_render(jm, o, d, ts, key=None, branch="full", jit=True):
    graphdef, state = nnx.split(jm)

    def render(st, oo, dd, tt, k):
        m = nnx.merge(graphdef, st)
        return m.ray_query(_tested(m, oo, dd, tt, jnp.asarray), key=k,
                           branch=branch)

    fn = jax.jit(render) if jit else render
    return fn(state, o, d, ts, key)


def _march_u(key, r: int):
    return np.array(jax.random.uniform(key, (r, N_STEPS), jnp.float32))


def _replay(us):
    it = iter(us)

    def draw(shape, lo, hi):
        u = next(it)
        assert tuple(u.shape) == tuple(shape) and (lo, hi) == (0.0, 1.0)
        return torch.from_numpy(u)
    return draw


@pytest.mark.parametrize("branch", ["full", "static", "dynamic"])
def test_render_matches_jax_ray_by_ray(models, branch):
    jm, flat = models
    tm = _torch_model(flat)
    o, d, ts = _rays(N_RAYS, 9)
    key = jax.random.key(10)
    rj, vbj = _jax_render(jm, o, d, ts, key, branch)
    fn = {"full": tm.ray_query, "static": tm.ray_query_static,
          "dynamic": tm.ray_query_dynamic}[branch]
    with torch.no_grad():
        rt, vbt = fn(_tested(tm, o, d, ts, torch.from_numpy),
                     draw=_replay([_march_u(key, N_RAYS)]))
    assert set(rt) == set(rj) and set(vbt) == set(vbj)
    for k, v in rt.items():
        assert torch.isfinite(v).all(), k
    assert float(rt["mask_volume"].mean()) > 0.05    # parity is not vacuous
    err = _ray_errs(rt, rj, ["rgb_volume", "depth_volume", "mask_volume",
                             "rgb_static_volume", "rgb_dynamic_volume"])
    assert (err <= 1e-4).mean() >= 0.99, err.max()
    np.testing.assert_allclose(vbt["t"].numpy(), np.asarray(vbj["t"]),
                               rtol=0, atol=1e-6)
    for k in ("reg_dynamic_sparsity", "reg_flow_smooth", "reg_flow_cycle",
              "reg_shadow"):
        np.testing.assert_allclose(float(vbt[k]), float(vbj[k]), rtol=1e-4,
                                   atol=1e-9)


def test_render_jit_matches_eager_jax(models):
    """The jitted JAX render moves no ray against eager JAX here, so the
    render tests may hold the port against the jitted one."""
    jm, _ = models
    o, d, ts = _rays(N_RAYS, 9)
    rj, _ = _jax_render(jm, o, d, ts, jit=True)
    re, _ = _jax_render(jm, o, d, ts, jit=False)
    for k in ("rgb_volume", "depth_volume", "mask_volume"):
        np.testing.assert_allclose(np.asarray(rj[k]), np.asarray(re[k]),
                                   rtol=0, atol=1e-5)


def test_model_level_temporal_aggregation_matches_jax():
    """A field without its own aggregation but with a flow head: the model
    averages the dynamic branch over the points warped to t ± Δ."""
    cfg = _cfg(temporal_aggregation=False)
    jm, flat = _seeded(cfg, seed=2)
    tm = _torch_model(flat, cfg)
    o, d, ts = _rays(N_RAYS, 11)
    rj, vbj = _jax_render(jm, o, d, ts)
    with torch.no_grad():
        rt, vbt = tm.ray_query(_tested(tm, o, d, ts, torch.from_numpy))
    assert "reg_flow_cycle" in vbt and set(vbt) == set(vbj)
    err = _ray_errs(rt, rj, ["rgb_volume", "depth_volume", "mask_volume"])
    assert (err <= 1e-4).mean() >= 0.99, err.max()
    np.testing.assert_allclose(float(vbt["reg_flow_cycle"]),
                               float(vbj["reg_flow_cycle"]), rtol=1e-4)


def test_only_dynamic_model_renders():
    cfg = dict(CFG, only_dynamic=True)
    cfg["field_cfg"] = {"dynamic_permuto_cfg": DYN_PERMUTO}
    jm, flat = _seeded(cfg, seed=3)
    tm = _torch_model(flat, cfg)
    o, d, ts = _rays(N_RAYS, 12)
    rj, _ = _jax_render(jm, o, d, ts)
    with torch.no_grad():
        rt, vbt = tm.ray_query(_tested(tm, o, d, ts, torch.from_numpy))
    assert "reg_shadow" not in vbt
    err = _ray_errs(rt, rj, ["rgb_volume", "depth_volume"])
    assert (err <= 1e-4).mean() >= 0.99, err.max()


# -------------------------------------------------------------- the step
def _loss_of(rendered, vb, gt, lib):
    """examples/train_dynamic_scene.py:116-124 with target |d|."""
    rgb_l = lib.mean((rendered["rgb_volume"] - gt) ** 2)
    return rgb_l + (1e-3 * vb["reg_dynamic_sparsity"]
                    + 1e-4 * vb["reg_flow_smooth"]
                    + 1e-4 * vb["reg_flow_cycle"]
                    + 1e-4 * vb["reg_shadow"])


def test_train_step_matches_jax(models):
    jm, flat = models
    tm = _torch_model(flat)
    o, d, ts = _rays(N_RAYS, 13)
    key = jax.random.key(14)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p):
        m = nnx.merge(graphdef, p, rest)
        rendered, vb = m.ray_query(_tested(m, o, d, ts, jnp.asarray),
                                   key=key)
        return _loss_of(rendered, vb, jnp.abs(jnp.asarray(d)), jnp)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    jg = {"/".join(str(p) for p in k): np.asarray(v[...])
          for k, v in nnx.to_flat_state(jg)}
    rendered, vb = tm.ray_query(_tested(tm, o, d, ts, torch.from_numpy),
                                draw=_replay([_march_u(key, N_RAYS)]))
    tl = _loss_of(rendered, vb, torch.abs(torch.from_numpy(d)), torch)
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(jg)
    errs = {k: float(np.linalg.norm(got[k] - jg[k]) /
                     max(np.linalg.norm(jg[k]), 1e-12)) for k in got}
    assert max(errs.values()) <= 1e-2, errs
    for k in TABLES:
        assert float(np.abs(got[k]).max()) > 0, k


def test_port_step_loss_falls(models):
    """Eight Adam(4e-3) steps of the port with the example's lifecycle:
    the loss falls."""
    _, flat = models
    tm = _torch_model(flat)
    opt = torch.optim.Adam(tm.parameters(), lr=4e-3)
    o, d, ts = _rays(N_RAYS, 15)
    g = torch.Generator().manual_seed(0)
    losses = []
    for it in range(8):
        tm.training_before_per_step(it, g)
        opt.zero_grad()
        rendered, vb = tm.ray_query(_tested(tm, o, d, ts, torch.from_numpy),
                                    generator=g)
        loss = _loss_of(rendered, vb, torch.abs(torch.from_numpy(d)), torch)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0], losses


# ------------------------------------------------------------ the accels
def _grid(shape, seed):
    return (np.random.default_rng(seed).uniform(size=shape) < 0.3
            ).astype(np.float32)


def _march_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = (rng.uniform(-0.5, 0.5, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = np.zeros(n, np.float32)
    far = np.full(n, 3.0, np.float32)
    return o, d, near, far


def test_batched_accels_match_jax():
    """`OccGridAccelBatched.ray_march`, `OccGridAccelDynamic.time_to_key`
    and `ray_march_at_time`, `OccGridAccelBatchedDynamic.slot` and
    `ray_march`, `OccGridAccelStaticAndDynamic.occ_at_time`: integers and
    masks exactly, t within 1e-6, bidx < 0 included, perturbed from JAX's
    draw."""
    from nr3d_lib_tpu.models.accelerations import get_accel as jget
    from nr3d_lib_tpu_torch.models.accelerations import get_accel as tget

    n, b, k = 40, 3, 4
    o, d, near, far = _march_rays(n, 16)
    rng = np.random.default_rng(17)
    bidx = rng.integers(-1, b, n).astype(np.int32)
    ts = rng.uniform(-1.2, 1.2, n).astype(np.float32)
    T = torch.from_numpy
    J = jnp.asarray
    key = jax.random.key(18)
    kw = dict(resolution=RES, step_size=0.1, max_steps_per_ray=24)
    u = np.array(jax.random.uniform(key, (n, 24), jnp.float32))

    def same(rt, rj):
        np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
        np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(rt.dt.numpy(), np.asarray(rj.dt),
                                   rtol=0, atol=1e-7)
        np.testing.assert_array_equal(rt.bidx.numpy(), np.asarray(rj.bidx))

    ja, ta = jget("occ_grid_batched", n_batch=b, **kw), \
        tget("occ_grid_batched", n_batch=b, device="cpu", **kw)
    g = _grid((b, RES, RES, RES), 19)
    ja.occ.val_grid[...] = J(g)
    ta.occ.val_grid.copy_(T(g))
    for pk, uu in ((None, None), (key, T(u))):
        same(ta.ray_march(T(bidx), T(o), T(d), T(near), T(far), u=uu),
             ja.ray_march(J(bidx), J(o), J(d), J(near), J(far), pk))
    assert not ta.ray_march(T(bidx), T(o), T(d), T(near), T(far)
                            ).mask[T(bidx) < 0].any()

    jd, td = jget("occ_grid_dynamic", n_time_keys=k, **kw), \
        tget("occ_grid_dynamic", n_time_keys=k, device="cpu", **kw)
    jd.ts_keyframes[...] = J(np.linspace(-1, 1, k, dtype=np.float32))
    g = _grid((k, RES, RES, RES), 20)
    jd.occ.val_grid[...] = J(g)
    td.occ.val_grid.copy_(T(g))
    np.testing.assert_array_equal(td.time_to_key(T(ts)).numpy(),
                                  np.asarray(jd.time_to_key(J(ts))))
    same(td.ray_march_at_time(T(ts), T(o), T(d), T(near), T(far), u=T(u)),
         jd.ray_march_at_time(J(ts), J(o), J(d), J(near), J(far), key))

    jb, tb = jget("occ_grid_batched_dynamic", n_batch=b, n_time_keys=k, **kw), \
        tget("occ_grid_batched_dynamic", n_batch=b, n_time_keys=k,
             device="cpu", **kw)
    jb.ts_keyframes[...] = J(np.linspace(-1, 1, k, dtype=np.float32))
    g = _grid((b * k, RES, RES, RES), 21)
    jb.occ.val_grid[...] = J(g)
    tb.occ.val_grid.copy_(T(g))
    np.testing.assert_array_equal(tb.slot(T(bidx), T(ts)).numpy(),
                                  np.asarray(jb.slot(J(bidx), J(ts))))
    for pk, uu in ((None, None), (key, T(u))):
        same(tb.ray_march(T(bidx), T(ts), T(o), T(d), T(near), T(far), u=uu),
             jb.ray_march(J(bidx), J(ts), J(o), J(d), J(near), J(far), pk))
    # collect_samples at (instance, time) slots, bidx < 0 dropped
    x = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    vals = rng.normal(size=n).astype(np.float32)
    jb.collect_samples(J(bidx), J(ts), J(x), J(vals))
    tb.collect_samples(T(bidx), T(ts), T(x), T(vals))
    np.testing.assert_array_equal(tb.occ.val_grid.numpy(),
                                  np.asarray(jb.occ.val_grid[...]))
    # the slotted update: query_fn(x, bidx, ts) per (instance, key) slot
    key2 = jax.random.key(22)

    def q(lib):
        return lambda xx, bb, tt: lib.sin(3.0 * xx[..., 0] + bb) * tt + \
            0.1 * xx[..., 1]

    jb.step(0, key2, q(jnp))
    idx, xs = _jax_draws(jb.occ, key2, RES ** 3 // 4)
    tb.occ.apply_update(idx, xs, lambda xx, sl: q(torch)(
        xx, sl // k, tb.ts_keyframes[sl % k]))
    np.testing.assert_allclose(tb.occ.val_grid.numpy(),
                               np.asarray(jb.occ.val_grid[...]), rtol=1e-6,
                               atol=1e-7)

    js, tsd = jget("occ_grid_static_and_dynamic", n_time_keys=k,
                   resolution=RES), \
        tget("occ_grid_static_and_dynamic", n_time_keys=k, resolution=RES,
             device="cpu")
    gs, gd = _grid((RES,) * 3, 23), _grid((k, RES, RES, RES), 24)
    js.static.val_grid[...] = J(gs)
    js.dynamic.occ.val_grid[...] = J(gd)
    tsd.static.val_grid.copy_(T(gs))
    tsd.dynamic.occ.val_grid.copy_(T(gd))
    for ki in range(k):
        np.testing.assert_array_equal(tsd.occ_at_time(ki).numpy(),
                                      np.asarray(js.occ_at_time(ki)))
    with pytest.raises(ValueError, match="Unknown accel"):
        tget("no_such_accel")
    assert type(tget("occ_grid", resolution=RES, device="cpu")).__name__ == \
        "OccGridAccel"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert TorchModel(**CFG).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchModel(**CFG)
