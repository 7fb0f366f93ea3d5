"""Port parity: the production train step of the brick-LoTD NeuS
(experiments/bench_render.py `main_train(kind="neus_compressed_w4")` and
`main_train(kind="neus_compressed", use_brick=True)`: perturbed compressed
query, MSE(rgb, |d|) + 0.1·eikonal over the valid packed nablas,
Adam(5e-3)) against the JAX package on the CPU, at a small size (128 rays,
decoder and radiance width 16, a 16³ grid, 64 hash rows). The tests of the
model are cases of both brick layouts, F=2 (three levels) and F=4 (two
levels, bf16-packed).

`jax.random` cannot be reproduced in torch. The JAX package's uniforms are
drawn with its own key split order (march, then one per upsample round)
and handed to the port through the query's `draw` seam; the occupancy
update's cells and points are handed over the same way.

Tolerances, per test: the samplers and the EMA update are elementwise
(2e-6 relative, a few ulps); optax and torch Adam compute the same update
(1e-6 relative). The final query from the same samples compares the loss to 1e-5 and each
parameter's gradient to 1e-4 in relative L2 (float32 sums in another
order, through the decoder's double backward). The whole step adds the
render's discrete choices: the `cdf <= u` bracket, the early-stop and
budget cuts move a ray whole on a last-ulp difference (PERF.md §2), so it
compares the loss to 1e-4 and each gradient to 1e-2 in relative L2
(measured over three seeds: loss within 4.1e-6, gradients within 2.4e-4,
except ln_s at 4.1e-3 where one ray's samples moved).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.model_base import LoTDNeuSModel as JaxModel
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.models.accelerations import cell_centers
from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss
from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel as TorchModel

torch.set_num_threads(1)

N_RAYS = 128
N_STEPS = 32
N_IMP = 8
LOTD = {2: {"lod_res": [16, 32, 64], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash"]},
        4: {"lod_res": [16, 64], "lod_n_feats": 4,
            "lod_types": ["Dense", "Hash"]}}
CDF_EPS = 1e-8


def _cfg(n_feats: int) -> dict:
    enc = {"lotd_cfg": {**LOTD[n_feats], "hashmap_size": 2 ** 16},
           "backend": "brick", "hashmap_rows": 64}
    return dict(
        field_cfg={"surface_cfg": {"encoding_cfg": enc,
                                   "decoder_cfg": {"D": 1, "W": 16}},
                   "radiance_cfg": {"D": 2, "W": 16}},
        accel_cfg={"resolution": 16, "max_steps_per_ray": N_STEPS,
                   "step_size": 2.0 / N_STEPS},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample_compressed",
                       "compression_factor": 0.25,
                       "march_budget_factor": 0.5, "n_importance": N_IMP})


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


def _jax_uniforms(key, r: int, rounds: int = 3):
    """The draws of the JAX compressed query, in its key split order
    (neus_ray_query_variants.py march key, neus_ray_query.py per round)."""
    pk, km = jax.random.split(key)
    us = [jax.random.uniform(km, (r, N_STEPS), jnp.float32)]
    for _ in range(rounds):
        pk, ki = jax.random.split(pk)
        us.append(jax.random.uniform(ki, (r, N_IMP), jnp.float32,
                                     minval=CDF_EPS, maxval=1.0 - CDF_EPS))
    return [np.array(u) for u in us]


def _replay(us):
    """A `draw` that hands out the given uniforms in order."""
    it = iter(us)

    def draw(shape, lo, hi):
        u = next(it)
        assert tuple(u.shape) == tuple(shape)
        assert lo <= float(u.min()) and float(u.max()) < max(hi, 1.0)
        return torch.from_numpy(u)
    return draw


def _seeded(n_feats: int):
    """The JAX model with seeded weights: table ±0.1, ln_s = ln(64)/10 and
    half the occupancy grid set; and its state as {path: numpy}."""
    jm = JaxModel(**_cfg(n_feats))
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
    return jm, flat, n_feats


@pytest.fixture(scope="module", params=[2, 4], ids=["F2", "F4"])
def models(request):
    return _seeded(request.param)


def _torch_model(flat, n_feats):
    tm = TorchModel(**_cfg(n_feats), device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    return tm


def _jax_loss_fn(graphdef, rest, rgb_gt, n_rays):
    """experiments/bench_render.py:197-221, the compressed NeuS branch."""
    def loss_fn(p, oo, dd, key):
        m = nnx.merge(graphdef, p, rest)
        rt = m.space.ray_test(oo, dd)
        rendered, vb = m.ray_query(rt, key=key)
        loss = jnp.mean((rendered["rgb_volume"] - rgb_gt) ** 2)
        nab = vb["nablas_packed"]
        w = (vb["ridx"] < n_rays).astype(nab.dtype)
        err = (jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2
        return loss + 0.1 * jnp.sum(err * w) / jnp.maximum(jnp.sum(w), 1.0)
    return loss_fn


def _torch_loss(tm, o, d, draw):
    rendered, vb = tm.ray_query(tm.ray_test(o, d), draw=draw)
    loss = torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2)
    return loss + 0.1 * eikonal_loss(vb["nablas_packed"],
                                     vb["ridx"] < o.shape[0])


def _grad_errors(tm, jgrads):
    """Relative L2 error of each parameter's gradient, by JAX path."""
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(jgrads)
    return {k: float(np.linalg.norm(got[k] - jgrads[k]) /
                     max(np.linalg.norm(jgrads[k]), 1e-12)) for k in got}


def _flat_grads(g) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(g)}


# ----------------------------------------------------------- the samplers
def test_perturbed_march_steps_match_jax():
    from nr3d_lib_tpu.ops.occgrid_march import march_steps as jms
    from nr3d_lib_tpu_torch.ops.occgrid_march import march_steps as tms

    rng = np.random.default_rng(1)
    near = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    far = near + rng.uniform(0.5, 2.0, 64).astype(np.float32)
    key = jax.random.key(3)
    tj, dtj, mj = jms(jnp.asarray(near), jnp.asarray(far), N_STEPS, 0.07,
                      perturb_key=key)
    u = np.array(jax.random.uniform(key, (64, N_STEPS), jnp.float32))
    tt, dtt, mt = tms(torch.from_numpy(near), torch.from_numpy(far), N_STEPS,
                      0.07, u=torch.from_numpy(u))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=2e-6,
                               atol=1e-6)
    np.testing.assert_allclose(dtt.numpy(), np.asarray(dtj), rtol=0, atol=0)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert not np.array_equal(tt.numpy(), tms(torch.from_numpy(near),
                                              torch.from_numpy(far), N_STEPS,
                                              0.07)[0].numpy())


def test_perturbed_sample_cdf_matches_jax():
    from nr3d_lib_tpu.graphics.raysample import batch_sample_pdf as jpdf
    from nr3d_lib_tpu_torch.graphics.raysample import batch_sample_pdf as tpdf

    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(0, 3, (64, 17)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (64, 16)).astype(np.float32)
    w[:8] = 0.0                                   # flat PDFs too
    key = jax.random.key(4)
    tj = jpdf(jnp.asarray(bins), jnp.asarray(w), N_IMP, perturb_key=key)
    u = np.array(jax.random.uniform(key, (64, N_IMP), jnp.float32,
                                      minval=CDF_EPS, maxval=1.0 - CDF_EPS))
    tt = tpdf(torch.from_numpy(bins), torch.from_numpy(w), N_IMP,
              u=torch.from_numpy(u))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=2e-6,
                               atol=1e-6)


# ------------------------------------------------------- occupancy update
def test_occ_step_update_matches_jax():
    from nr3d_lib_tpu.models.accelerations.occgrid import OccGridEma as JOcc
    from nr3d_lib_tpu_torch.models.accelerations.occgrid import \
        OccGridEma as TOcc

    res, n = (16, 16, 16), 512
    rng = np.random.default_rng(3)
    grid = (rng.uniform(size=res) < 0.2).astype(np.float32) * \
        rng.uniform(0.0, 2.0, res).astype(np.float32)
    jo, to = JOcc(res, ema_decay=0.9), TOcc(res, ema_decay=0.9, device="cpu")
    jo.val_grid[...] = jnp.asarray(grid)
    to.val_grid.copy_(torch.from_numpy(grid))

    def field(x, lib):
        return lib.sin(3.0 * x[:, 0]) * lib.cos(2.0 * x[:, 1]) + 0.3 * x[:, 2]

    key = jax.random.key(7)
    jo.step_update(key, lambda x: field(x, jnp), n_samples=n)
    # the cells and points JAX drew, in OccGridEma.step_update's order
    from nr3d_lib_tpu.models.accelerations.occgrid import sample_cells_uniform
    k_uni, k_occ, k_jit = jax.random.split(key, 3)
    idx_u, x_u = sample_cells_uniform(k_uni, res, n, jnp.float32)
    occ_flat = jnp.asarray(grid > 0.01).reshape(-1)
    flat_idx = jax.random.categorical(
        k_occ, jnp.where(occ_flat, 0.0, -jnp.inf), shape=(n,))
    idx_o = jnp.stack(jnp.unravel_index(flat_idx, res), -1)
    x_o = (idx_o.astype(jnp.float32) +
           jax.random.uniform(k_jit, (n, 3), jnp.float32)) / 16.0 * 2.0 - 1.0
    idx = torch.from_numpy(np.asarray(jnp.concatenate([idx_u, idx_o])))
    x = torch.from_numpy(np.asarray(jnp.concatenate([x_u, x_o]),
                                    np.float32))
    to.apply_update(idx.long(), x, lambda xx: field(xx, torch))
    np.testing.assert_allclose(to.val_grid.numpy(),
                               np.asarray(jo.val_grid[...]), rtol=1e-6,
                               atol=1e-7)
    assert int(to.it) == int(jo.it[...]) == 1


def test_occ_sample_update_cells():
    """The port's own draw: n uniform cells, then n occupied cells (with
    replacement), each with a point inside it; uniform when nothing is
    occupied."""
    from nr3d_lib_tpu_torch.models.accelerations.occgrid import OccGridEma

    occ = OccGridEma((8, 8, 8), device="cpu")
    occ.val_grid.zero_()
    occ.val_grid[1, 2, 3] = occ.val_grid[5, 0, 7] = 1.0
    g = torch.Generator().manual_seed(0)
    idx, x = occ.sample_update_cells(g, n_samples=300)
    assert idx.shape == (600, 3) and x.shape == (600, 3)
    cell = torch.floor((x + 1.0) * 0.5 * 8).long()
    assert torch.equal(cell, idx)
    occupied = {tuple(v) for v in idx[300:].tolist()}
    assert occupied == {(1, 2, 3), (5, 0, 7)}
    assert len({tuple(v) for v in idx[:300].tolist()}) > 200
    occ.val_grid.zero_()
    idx, _ = occ.sample_update_cells(g, n_samples=300)
    assert len({tuple(v) for v in idx[300:].tolist()}) > 200
    before = occ.val_grid.clone()
    occ.step_update(lambda xx: torch.zeros(xx.shape[0]), g, n_samples=10)
    assert torch.equal(occ.val_grid, before * 0.95) and int(occ.it) == 1


def test_training_hooks(models):
    _, flat, n_feats = models
    tm = _torch_model(flat, n_feats)
    assert tm.lifecycle_update_every == 16
    before = tm.accel.occ.val_grid.clone()
    g = torch.Generator().manual_seed(0)
    tm.training_before_per_step(5, g)             # off the interval: no-op
    assert torch.equal(tm.accel.occ.val_grid, before)
    tm.training_before_per_step(16, g)
    assert int(tm.accel.occ.it) == 1
    assert not torch.equal(tm.accel.occ.val_grid, before)
    tm.training_after_per_step(16)
    # use_ema=False builds the getter grid: re-queried whole on the
    # interval, untouched off it (its parity with JAX is held in
    # test_torch_occgrid_leftovers.py)
    cfg = _cfg(n_feats)
    tg = TorchModel(**{**cfg, "accel_cfg": {**cfg["accel_cfg"],
                                            "use_ema": False}}, device="cpu")
    sd = tm.state_dict()
    sd.pop("accel.occ.val_grid"), sd.pop("accel.occ.it")
    tg.load_state_dict({**sd, "accel.occ.occ_grid":
                        tg.accel.occ.occ_grid.clone()}, strict=True)
    tg.training_before_per_step(5, g)
    assert bool(tg.accel.occ.occ_grid.all())
    tg.training_before_per_step(16, g)
    with torch.no_grad():
        want = tg.query_occ_val(cell_centers((16, 16, 16))).abs() > 0.01
    assert torch.equal(tg.accel.occ.occ_grid.reshape(-1), want)


# ------------------------------------------------------ Adam and the bridge
def test_adam_matches_optax():
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((7, 5)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 10 ** -i
              for k, v in p0.items()} for i in range(3)]
    opt = optax.adam(5e-3)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(pj)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = torch.optim.Adam(list(pt.values()), lr=5e-3)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state)
        pj = optax.apply_updates(pj, upd)
        for k, p in pt.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k in p0:
            np.testing.assert_allclose(pt[k].detach().numpy(),
                                       np.asarray(pj[k]), rtol=1e-6,
                                       atol=1e-7)


def test_bridge_inverse_round_trip(models):
    _, flat, n_feats = models
    tm = _torch_model(flat, n_feats)
    back = to_jax_paths(tm.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    assert set(to_jax_paths(dict(tm.named_parameters()))) == {
        "field/implicit_surface/encoding/flattened_params",
        "field/implicit_surface/decoder/ws/0",
        "field/implicit_surface/decoder/ws/1",
        "field/implicit_surface/decoder/bs/0",
        "field/implicit_surface/decoder/bs/1",
        "field/radiance/mlp/ws/0", "field/radiance/mlp/ws/1",
        "field/radiance/mlp/ws/2", "field/radiance/mlp/bs/0",
        "field/radiance/mlp/bs/1", "field/radiance/mlp/bs/2",
        "field/var_ctrl/ln_s"}


# ------------------------------------------------------------ the step
def test_final_query_grads_from_same_samples(models):
    """The differentiated part of the step from the same samples: the
    packed query (sdf, nablas through the decoder's vjp and the encoding's
    nablas path, rgb), the composite, rgb MSE + 0.1·eikonal. Tight."""
    from nr3d_lib_tpu.graphics import nerf as jn
    from nr3d_lib_tpu.graphics import neus as jneus
    from nr3d_lib_tpu_torch.graphics import nerf as tn
    from nr3d_lib_tpu_torch.graphics import neus as tneus

    jm, flat, n_feats = models
    tm = _torch_model(flat, n_feats)
    o, d = _rays(N_RAYS, 3)
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0.5, 3.0, (N_RAYS, 10)), -1).astype(np.float32)
    valid = rng.uniform(size=(N_RAYS, 10)) < 0.8
    x = (o[:, None] * 0.5 + d[:, None] * 0.5 * t[..., None]).reshape(-1, 3)
    v = np.broadcast_to(d[:, None], (N_RAYS, 10, 3)).reshape(-1, 3)
    def step_loss(m, lib, where, out, inv_s, eik, gt):
        sdf = where(valid, out["sdf"].reshape(N_RAYS, 10), 1e4)
        alpha = where(valid, lib[1].neus_ray_sdf_to_alpha(
            sdf, inv_s, append_cdf_1=True), 0.0)
        vw = lib[0].ray_alpha_to_vw(alpha)
        rgb = (vw[..., None] * out["rgb"].reshape(N_RAYS, 10, 3)).sum(-2)
        return ((rgb - gt) ** 2).mean() + 0.1 * eik(out["nablas"])

    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def jloss(p):
        m = nnx.merge(graphdef, p, rest)
        out = m(jnp.asarray(x), jnp.asarray(v))
        return step_loss(m, (jn, jneus), jnp.where, out, m.forward_inv_s(),
                         lambda nab: jnp.sum(
                             (jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2 *
                             valid.reshape(-1)) / valid.sum(),
                         jnp.abs(jnp.asarray(d)))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    vt = torch.from_numpy(valid)
    out = tm(torch.from_numpy(x), torch.from_numpy(v))
    tl = step_loss(tm, (tn, tneus),
                   lambda c, a, b: torch.where(vt, a, torch.as_tensor(b)),
                   out, tm.forward_inv_s(),
                   lambda nab: eikonal_loss(nab, vt.reshape(-1)),
                   torch.abs(torch.from_numpy(d)))
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    errs = _grad_errors(tm, _flat_grads(jg))
    assert max(errs.values()) <= 1e-4, errs
    # the eikonal term reaches the decoder weights through the vjp's output
    tm.zero_grad()
    eikonal_loss(tm(torch.from_numpy(x), torch.from_numpy(v),
                    with_rgb=False)["nablas"]).backward()
    assert float(tm.field.implicit_surface.decoder.ws[1].grad.abs().max()) > 0


def test_whole_train_step_matches_jax(models):
    jm, flat, n_feats = models
    tm = _torch_model(flat, n_feats)
    o, d = _rays(N_RAYS, 5)
    key = jax.random.key(11)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)
    loss_fn = _jax_loss_fn(graphdef, rest, jnp.abs(jnp.asarray(d)), N_RAYS)
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(o), jnp.asarray(d), key)
    tl = _torch_loss(tm, torch.from_numpy(o), torch.from_numpy(d),
                     _replay(_jax_uniforms(key, N_RAYS)))
    tl.backward()
    assert np.isfinite(float(tl))
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), \
        (float(tl), float(jl))
    errs = _grad_errors(tm, _flat_grads(jg))
    assert max(errs.values()) <= 1e-2, errs


def test_port_step_loss_falls(models):
    """Eight Adam steps of the port on the CPU from the seeded weights and
    perturbed samples: the loss falls (the trend the card's run checks)."""
    _, flat, n_feats = models
    tm = _torch_model(flat, n_feats)
    opt = torch.optim.Adam(tm.parameters(), lr=5e-3)
    o, d = (torch.from_numpy(a) for a in _rays(N_RAYS, 6))
    g = torch.Generator().manual_seed(0)
    losses = []
    for it in range(1, 9):
        tm.training_before_per_step(it, g)
        opt.zero_grad()
        rendered, vb = tm.ray_query(tm.ray_test(o, d), generator=g)
        loss = torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2) + \
            0.1 * eikonal_loss(vb["nablas_packed"], vb["ridx"] < N_RAYS)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0], losses
