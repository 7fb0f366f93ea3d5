"""Port parity: the dynamic (x,t) permutohedral NeuS
(`DynamicPermutoNeuSModel`, examples/configs/dynamic_permuto_w4.yaml's
model family) against the JAX package on the CPU, at a small size: the
cell permuto with 2 levels (res 4 dense, res 11 hashed into 2048 rows), in
both layouts — F=4 bf16-packed (the yaml's) and F=2 (the field's default)
—, decoder and radiance width 16, 4 time keys over an 8³ grid each, 64
rays, 16 coarse samples and two upsample rounds of 8. The tests that go
through the encoding (the bridge, the occupancy query, the render, the
train step) take the `models` fixture, parametrized over F; the others
take `models4`, the F=4 model alone.

Weights cross by the state bridge (`bridge.from_jax_state`); the table
scale and ln_s = ln(64)/10 are raised from the defaults so the render is
not trivially empty. `jax.random` cannot be reproduced in torch: the JAX
package's uniforms are drawn in its key split order (coarse samples, then
one per upsample round) and handed to the port's `draw` seam, and the
occupancy update's cells and points the same way.

Tolerances: samplers, time maps and the EMA update are elementwise (2e-6
relative). The render makes discrete choices (the inverse-CDF bracket of
the upsampling), so it is compared ray by ray: all rays within 1e-5 or at
least 99% within 1e-4 (measured: all rays within 1e-6 for both layouts).
One train step compares the loss to 1e-5 relative and each parameter's
gradient to 1e-4 relative L2, by JAX path (float32 sums in another order
through the decoder's vjp and the table's scatter; measured: 1.5e-7 and
3.5e-6 at F=4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.model_families import DynamicPermutoNeuSModel \
    as JaxModel
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss
from nr3d_lib_tpu_torch.models.model_families import DynamicPermutoNeuSModel \
    as TorchModel
from nr3d_lib_tpu_torch.ops import _build

torch.set_num_threads(1)

N_RAYS = 64
N_COARSE = 16
N_IMP = 8
N_KEYS = 4
RES = 8
CDF_EPS = 1e-8


def _cfg(n_feats: int) -> dict:
    return dict(
        field_cfg={"surface_cfg": {
            "permuto_cfg": {"res_list": [4.0, 11.0], "backend": "cell",
                            "n_feats": n_feats, "hashmap_rows": 2048},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 2, "W": 16}},
        accel_cfg={"resolution": RES}, n_time_keys=N_KEYS,
        ray_query_cfg={"n_coarse": N_COARSE, "n_importance": N_IMP})


CFG = _cfg(4)


def _flat_state(model) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(model))}


def _rays(n: int, seed: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ts = rng.uniform(-1.0, 1.0, n)
    return o.astype(np.float32), d.astype(np.float32), ts.astype(np.float32)


def _seeded(n_feats: int):
    """The JAX model with seeded weights (table ±0.1, ln_s = ln(64)/10)
    and its state as {path: numpy}. The suite runs JAX with x64 on, which
    makes the accel's default `linspace` keyframes float64: they are set
    to their float32 values on both sides (the production dtype)."""
    jm = JaxModel(**_cfg(n_feats))
    rng = np.random.default_rng(0)
    flat = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in _flat_state(jm).items()}
    key = "field/implicit_surface/bank/flattened_params"
    flat[key] = rng.uniform(-0.1, 0.1, flat[key].shape).astype(np.float32)
    flat["field/var_ctrl/ln_s"] = np.asarray(np.log(64.0) / 10.0, np.float32)
    state = nnx.state(jm)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(jm, state)
    return jm, flat


@pytest.fixture(scope="module", params=[2, 4], ids=["F2", "F4"])
def models(request):
    """(JAX model, its state) of each layout."""
    return _seeded(request.param)


@pytest.fixture(scope="module")
def models4():
    """(JAX model, its state) of the F=4 layout."""
    return _seeded(4)


def _n_feats(flat) -> int:
    return flat["field/implicit_surface/bank/flattened_params"].shape[1] // 64


def _torch_model(flat):
    tm = TorchModel(**_cfg(_n_feats(flat)), device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    return tm


def _tested(model, o, d, ts, lib):
    rt = model.ray_test(lib(o), lib(d))
    rt["ts"] = lib(ts)
    return rt


def _jax_uniforms(key, r: int, rounds: int = 2):
    """The draws of `neus_ray_query_dynamic`, in its key split order."""
    pk, kc = jax.random.split(key)
    us = [jax.random.uniform(kc, (r, N_COARSE), jnp.float32)]
    for _ in range(rounds):
        pk, ki = jax.random.split(pk)
        us.append(jax.random.uniform(ki, (r, N_IMP), jnp.float32,
                                     minval=CDF_EPS, maxval=1.0 - CDF_EPS))
    return [np.array(u) for u in us]


def _replay(us):
    it = iter(us)

    def draw(shape, lo, hi):
        u = next(it)
        assert tuple(u.shape) == tuple(shape)
        assert lo <= float(u.min()) and float(u.max()) < max(hi, 1.0)
        return torch.from_numpy(u)
    return draw


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
def test_bridge_maps_the_dynamic_paths(models):
    _, flat = models
    tm = _torch_model(flat)
    for path in ("field/implicit_surface/bank/flattened_params",
                 "space/ts_keyframes", "accel/ts_keyframes",
                 "accel/occ/val_grid"):
        assert path in flat
    back = to_jax_paths(tm.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    f = _n_feats(flat)
    bank = tm.field.implicit_surface.bank
    assert bank.n_feats == f and bank.out_features == 2 * f
    assert bank.flattened_params.shape == (2048 + 1792, 64 * f)


# ------------------------------------------------- space, accel, samplers
def test_space_time_maps_match_jax():
    from nr3d_lib_tpu.models.spatial.aabb import AABBDynamicSpace as JSpace
    from nr3d_lib_tpu_torch.models.spatial import AABBDynamicSpace as TSpace

    ts = np.linspace(0.3, 2.2, 17).astype(np.float32)
    js = JSpace(ts_keyframes=[0.5, 1.0, 2.0])
    tsp = TSpace(ts_keyframes=[0.5, 1.0, 2.0], device="cpu")
    for fn in ("normalize_ts", "unnormalize_ts"):
        np.testing.assert_allclose(
            getattr(tsp, fn)(torch.from_numpy(ts)).numpy(),
            np.asarray(getattr(js, fn)(jnp.asarray(ts))), rtol=2e-6,
            atol=1e-7)
    assert TSpace(device="cpu").ts_keyframes.tolist() == [0.0, 1.0]


def test_time_to_key_matches_jax(models4):
    jm, flat = models4
    tm = _torch_model(flat)
    ts = np.concatenate([np.linspace(-1.2, 1.2, 41),
                         np.asarray(flat["accel/ts_keyframes"])]
                        ).astype(np.float32)
    np.testing.assert_array_equal(
        tm.accel.time_to_key(torch.from_numpy(ts)).numpy(),
        np.asarray(jm.accel.time_to_key(jnp.asarray(ts))))


def test_step_linear_matches_jax():
    from nr3d_lib_tpu.graphics.raysample import batch_sample_step_linear as js
    from nr3d_lib_tpu_torch.graphics.raysample import \
        batch_sample_step_linear as ts_

    rng = np.random.default_rng(1)
    near = rng.uniform(0.0, 1.0, 32).astype(np.float32)
    far = near + rng.uniform(0.5, 2.0, 32).astype(np.float32)
    key = jax.random.key(2)
    u = np.array(jax.random.uniform(key, (32, N_COARSE), jnp.float32))
    for k, uu in ((None, None), (key, torch.from_numpy(u))):
        tj, dtj = js(jnp.asarray(near), jnp.asarray(far), N_COARSE, k)
        tt, dtt = ts_(torch.from_numpy(near), torch.from_numpy(far),
                      N_COARSE, uu)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=2e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(dtt.numpy(), np.asarray(dtj), rtol=2e-6,
                                   atol=1e-6)


def test_batched_occ_update_matches_jax():
    from nr3d_lib_tpu.models.accelerations.occgrid_batched import \
        OccGridEmaBatched as JOcc
    from nr3d_lib_tpu_torch.models.accelerations import \
        OccGridEmaBatched as TOcc

    rng = np.random.default_rng(3)
    grid = (rng.uniform(size=(3, RES, RES, RES)) < 0.3).astype(np.float32)
    jo, to = JOcc(3, RES, ema_decay=0.9), TOcc(3, RES, ema_decay=0.9,
                                               device="cpu")
    jo.val_grid[...] = jnp.asarray(grid)
    to.val_grid.copy_(torch.from_numpy(grid))

    def field(x, b, lib):
        return lib.sin(3.0 * x[..., 0] + b) * lib.cos(2.0 * x[..., 1]) + \
            0.3 * x[..., 2]

    key = jax.random.key(4)
    jo.step_update(key, lambda x, b: field(x, b, jnp), n_samples=64)
    idx, x = _jax_draws(jo, key, 64)
    to.apply_update(idx, x, lambda xx, b: field(xx, b, torch))
    np.testing.assert_allclose(to.val_grid.numpy(),
                               np.asarray(jo.val_grid[...]), rtol=1e-6,
                               atol=1e-7)
    # the port's own draw: n cells per grid, each point inside its cell
    g = torch.Generator().manual_seed(0)
    idx, x = to.sample_update_cells(g)
    assert idx.shape == (3, RES ** 3 // 4, 3) and x.shape == idx.shape
    assert torch.equal(torch.floor((x + 1.0) * 0.5 * RES).long(), idx)


def test_collect_samples_matches_jax():
    from nr3d_lib_tpu.models.accelerations.occgrid_batched import \
        OccGridEmaBatched as JOcc
    from nr3d_lib_tpu_torch.models.accelerations import \
        OccGridEmaBatched as TOcc

    rng = np.random.default_rng(5)
    jo, to = JOcc(2, RES), TOcc(2, RES, device="cpu")
    grid = rng.uniform(0.0, 0.5, (2, RES, RES, RES)).astype(np.float32)
    jo.val_grid[...] = jnp.asarray(grid)
    to.val_grid.copy_(torch.from_numpy(grid))
    x = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    b = rng.integers(-1, 2, 300).astype(np.int32)
    v = rng.normal(size=300).astype(np.float32)
    jo.collect_samples(jnp.asarray(b), jnp.asarray(x), jnp.asarray(v))
    to.collect_samples(torch.from_numpy(b), torch.from_numpy(x),
                       torch.from_numpy(v))
    np.testing.assert_array_equal(to.val_grid.numpy(),
                                  np.asarray(jo.val_grid[...]))
    assert not np.array_equal(to.val_grid.numpy(), grid)


def test_occupancy_query_matches_jax(models):
    """One EMA update of every time key's grid from the model's own query
    (the time-keyed SDF), from JAX's draws."""
    jm, flat = models
    tm = _torch_model(flat)
    jm2 = JaxModel(**_cfg(_n_feats(flat)))
    nnx.update(jm2, nnx.state(jm))
    key = jax.random.key(6)
    jm2.populate(key)
    idx, x = _jax_draws(jm2.accel.occ, key, RES ** 3 // 4)
    with torch.no_grad():
        tm.accel.occ.apply_update(idx, x, tm._accel_query)
    np.testing.assert_allclose(tm.accel.occ.val_grid.numpy(),
                               np.asarray(jm2.accel.occ.val_grid[...]),
                               rtol=1e-5, atol=1e-6)


def test_training_hooks(models4):
    _, flat = models4
    tm = _torch_model(flat)
    assert tm.lifecycle_update_every == 16
    before = tm.accel.occ.val_grid.clone()
    g = torch.Generator().manual_seed(0)
    tm.training_before_per_step(5, g)              # off the interval: no-op
    assert torch.equal(tm.accel.occ.val_grid, before)
    tm.training_before_per_step(16, g)
    assert not torch.equal(tm.accel.occ.val_grid, before)
    tm.populate()
    tm.training_after_per_step(16)


# ------------------------------------------------------------ the render
def test_render_matches_jax_ray_by_ray(models):
    jm, flat = models
    tm = _torch_model(flat)
    o, d, ts = _rays(N_RAYS, 7)
    graphdef, state = nnx.split(jm)

    @jax.jit
    def render(st, oo, dd, tt):
        m = nnx.merge(graphdef, st)
        rt = m.ray_test(oo, dd)
        rt["ts"] = tt
        return m.ray_query(rt)

    rj, vbj = render(state, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts))
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        rt, vbt = tm.ray_query(_tested(tm, o, d, ts, torch.from_numpy))
    assert dict(_build.LAUNCHES) == before           # the CPU route
    assert vbt["t"].shape == (N_RAYS, N_COARSE + 2 * N_IMP)
    assert vbt["nablas"].shape == (N_RAYS, N_COARSE + 2 * N_IMP, 3)
    for k in ("rgb_volume", "depth_volume", "mask_volume"):
        assert torch.isfinite(rt[k]).all(), k
    assert float(rt["mask_volume"].mean()) > 0.1      # parity is not vacuous
    err = np.zeros(N_RAYS)
    for k in ("rgb_volume", "depth_volume", "mask_volume"):
        e = np.abs(rt[k].numpy() - np.asarray(rj[k])).reshape(N_RAYS, -1)
        err = np.maximum(err, e.max(-1))
    assert (err <= 1e-5).all(), err.max()
    np.testing.assert_allclose(vbt["t"].numpy(), np.asarray(vbj["t"]),
                               rtol=0, atol=1e-5)


def test_time_conditions_the_render(models4):
    _, flat = models4
    tm = _torch_model(flat)
    o, d, ts = _rays(N_RAYS, 8)
    with torch.no_grad():
        r1, _ = tm.ray_query(_tested(tm, o, d, ts, torch.from_numpy))
        r2, _ = tm.ray_query(_tested(tm, o, d, -ts, torch.from_numpy))
    assert not torch.allclose(r1["rgb_volume"], r2["rgb_volume"])
    assert not torch.allclose(r1["depth_volume"], r2["depth_volume"])


# -------------------------------------------------------------- the step
def _jax_step(jm, o, d, ts, key):
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)
    gt = jnp.abs(jnp.asarray(d))

    def loss_fn(p, oo, dd, tt, k):
        m = nnx.merge(graphdef, p, rest)
        rt = m.ray_test(oo, dd)
        rt["ts"] = tt
        rendered, vb = m.ray_query(rt, key=k)
        nrm = jnp.linalg.norm(vb["nablas"], axis=-1)
        return jnp.mean((rendered["rgb_volume"] - gt) ** 2) + \
            0.1 * jnp.mean((nrm - 1.0) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts), key)
    return float(jl), {"/".join(str(p) for p in k): np.asarray(v[...])
                       for k, v in nnx.to_flat_state(jg)}


def _torch_loss(tm, o, d, ts, **query):
    rendered, vb = tm.ray_query(_tested(tm, o, d, ts, torch.from_numpy),
                                **query)
    return torch.mean((rendered["rgb_volume"] - torch.abs(
        torch.from_numpy(d))) ** 2) + 0.1 * eikonal_loss(vb["nablas"])


def test_train_step_matches_jax(models):
    jm, flat = models
    tm = _torch_model(flat)
    o, d, ts = _rays(N_RAYS, 9)
    key = jax.random.key(11)
    jl, jg = _jax_step(jm, o, d, ts, key)
    tl = _torch_loss(tm, o, d, ts,
                     draw=_replay(_jax_uniforms(key, N_RAYS)))
    tl.backward()
    assert np.isfinite(float(tl))
    assert abs(float(tl) - jl) <= 1e-5 * abs(jl), (float(tl), jl)
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(jg)
    errs = {k: float(np.linalg.norm(got[k] - jg[k]) /
                     max(np.linalg.norm(jg[k]), 1e-12)) for k in got}
    assert max(errs.values()) <= 1e-4, errs
    assert float(np.abs(got["field/implicit_surface/bank/flattened_params"])
                 .max()) > 0


def test_port_step_loss_falls(models4):
    """Eight Adam steps of the port on the CPU from the seeded weights
    with perturbed samples: the loss falls (the trend the card's run
    checks)."""
    _, flat = models4
    tm = _torch_model(flat)
    opt = torch.optim.Adam(tm.parameters(), lr=5e-3)
    o, d, ts = _rays(N_RAYS, 10)
    g = torch.Generator().manual_seed(0)
    losses = []
    for it in range(1, 9):
        tm.training_before_per_step(it, g)
        opt.zero_grad()
        loss = _torch_loss(tm, o, d, ts, generator=g)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0], losses


# -------------------------------------------------- what is not ported
def test_bank_configurations():
    """The classic lattice (the JAX default) builds at d = 4; the cell
    bank's any-order encode exists for CPU tensors only."""
    from nr3d_lib_tpu_torch.models.grid_encodings.permuto import \
        PermutoParams

    xla = PermutoParams(4, [4.0], backend="xla", device="cpu")
    assert xla.flattened_params.shape == (2 ** 18 * 2,)
    assert xla.encode(torch.rand(5, 4)).shape == (5, 2)
    bank = PermutoParams(4, [4.0], backend="cell", n_feats=4, device="cpu")
    y = bank.encode(torch.rand(5, 4), ho=True)
    assert y.shape == (5, 4)
    with pytest.raises(NotImplementedError, match="nablas"):
        bank.encode(torch.rand(5, 4, device="meta"), ho=True)


def test_f2_cell_bank_builds():
    """The F=2 cell bank (the cell backend's default): an f32 [rows, 128]
    table, 2L outputs, the any-order plain encode on the CPU."""
    from nr3d_lib_tpu_torch.models.grid_encodings.permuto import \
        PermutoParams

    bank = PermutoParams(4, [4.0, 11.0], backend="cell", hashmap_rows=2048,
                         device="cpu")
    assert bank.n_feats == 2 and bank.out_features == 4
    assert bank.flattened_params.shape == (bank.meta.total_rows, 128)
    assert float(bank.flattened_params.detach().abs().max()) <= 1e-4
    inp = torch.rand(5, 3, 4)
    y = bank.encode(inp)
    assert y.shape == (5, 3, 4)
    torch.testing.assert_close(bank.encode(inp, ho=True), y)
    assert bank.nablas(torch.ones(5, 3, 4), inp).shape == (5, 3, 4)
    with pytest.raises(ValueError, match="2 or 4"):
        PermutoParams(4, [4.0], backend="cell", n_feats=3, device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert TorchModel(**CFG).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchModel(**CFG)
