"""Port parity: training the forest NeuS, and the rest of the forest's
modules, against the JAX package on the CPU.

* The forest forms of the encode's and nablas' backwards (the plain
  versions of B7 and B9 with a block row offset):
  `brick_encode_bwd_xla_batched` against the `jax.vjp` of
  `brick_encode_xla_batched`, and `brick_nablas_bwd_xla_batched` and
  the wrappers' second order against `jax.grad` through
  `brick_nablas_batched`'s off-TPU backward, as tests/test_forest_brick.py
  does. The points fall in several blocks, some with bidx < 0, and whole
  32-runs sit at one block-local slot in different blocks.
* One step of `examples/train_forest_street.py:119-131` (loss =
  MSE(rgb, target) + 0.01·mean((‖nablas_packed‖ − 1)²) over every packed
  slot, padding included, then Adam(1e-2)) on a small forest (2×2×2
  blocks, `lod_res [8, 16]`, width 16, 64 rays) loaded through
  `forest_from_jax_state`, perturbed with JAX's uniforms through `draw`:
  the loss, every parameter's gradient, and the parameters after one
  Adam step against `optax.adam(1e-2)`.
* `ForestBlockSpace.populate_from_{waypoints,mesh,pinhole_cameras}`,
  `OccGridAccelForest.collect_samples` and `debug_stats`,
  `occgrid_march_batched_dense`, `graphics.raymarch.occgrid_raymarch`
  and `occgrid_raymarch_batched`.

JAX runs eagerly (op by op): under `jax.jit` XLA's CPU compiler fuses the
forest march's t and moves rays (tests/test_torch_forest.py). Inputs are
float32 from numpy seeds (the conftest turns on x64).

Tolerances: the plain backwards sum corner products in another order.
The encode's: dL/dtable within 1e-6 absolute, dL/dx within 1e-5 plus
2e-6 relative (it carries the levels' resolution, up to ~30 at a ±1
table), as the forward tests. The nablas' backward and the second order
carry the resolution twice (dL/dx up to ~9,000 here): each output within
1e-6 of its largest entry (measured 1.2e-7). The train step passes NeuS upsampling and a
budgeted compaction, which can move a ray's samples on a last-ulp
difference: the loss within 1e-4 relative and each gradient within 1e-2
relative L2, the standard of PERF.md §2 (measured on this seed: loss
5.6e-7 relative, gradients ≤ 1.4e-5). After one Adam step every
parameter within 1e-2·lr of optax's (Adam's first step moves an entry
by lr·g/(|g| + 1e-8), so the gradients' 1e-2 carries to 1e-2 of a step;
measured 6.9e-6, at entries whose gradient is near 1e-8), and with
JAX's gradients handed to the port's Adam within 1e-7 (measured
3.0e-8: the same update). The space's populates mark the same blocks
(exact), the occupancy scatter and the batched march are elementwise
(exact masks, t within 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.fields_forest import LoTDForestNeuSModel as JaxForest
from nr3d_lib_tpu.models.spatial.forest import ForestBlockSpace as JaxSpace
from nr3d_lib_tpu.ops import lotd_brick as JB
from nr3d_lib_tpu_torch.bridge import forest_from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.models.fields_forest import \
    LoTDForestNeuSModel as TorchForest
from nr3d_lib_tpu_torch.models.spatial.forest import \
    ForestBlockSpace as TorchSpace
from nr3d_lib_tpu_torch.ops import lotd_brick as TB

torch.set_num_threads(1)

N_RAYS = 64
LR = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _rays(n: int, seed: int, radius: float = 2.5):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * radius
    d = -o / radius + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _close(got, want, rel: float = 1e-6):
    """Within `rel` of the largest entry of `want` (plus 1e-6)."""
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=0,
        atol=rel * float(np.abs(want).max()) + 1e-6)


# -------------------------------------- the forest forms of B7 and B9
def _inputs(n: int, blocks: int, seed: int):
    """Points in `blocks` blocks, bidx −1 included; the second 32-run is
    one point in four blocks by lane (one block-local slot in each)."""
    lod_res, types = [8, 16, 32], ["Dense", "Dense", "Hash"]
    jmeta = JB.make_forest_meta(JB.make_brick_meta(lod_res, types, 64))
    tmeta = TB.make_forest_meta(TB.make_brick_meta(lod_res, types, 64))
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:8] = np.round(x[:8] * 14) / 14            # points on cell faces
    x[32:64] = x[32]
    table = rng.uniform(-1, 1, (blocks * tmeta.total_rows, 128)
                        ).astype(np.float32)
    bidx = rng.integers(-1, blocks, n).astype(np.int32)
    bidx[32:64] = np.arange(32) % 4
    g = rng.normal(size=(n, 2 * tmeta.n_levels)).astype(np.float32)
    gg = rng.normal(size=(n, 3)).astype(np.float32)
    return jmeta, tmeta, x, table, bidx, g, gg


def test_brick_encode_bwd_batched_matches_jax_vjp():
    jmeta, tmeta, x, table, bidx, g, _ = _inputs(300, 5, 1)
    _, vjp = jax.vjp(lambda xx, tt: JB.brick_encode_xla_batched(
        xx, tt, jmeta, jnp.asarray(bidx)), jnp.asarray(x), jnp.asarray(table))
    dxj, dtj = vjp(jnp.asarray(g))
    dxt, dtt = TB.brick_encode_bwd_xla_batched(_t(x), _t(table), _t(g),
                                               tmeta, _t(bidx))
    np.testing.assert_allclose(dtt.numpy(), np.asarray(dtj), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(dxt.numpy(), np.asarray(dxj), rtol=2e-6,
                               atol=1e-5)
    # every block but the last got a gradient; the four blocks of the
    # shared slot each hold their own lanes' sum
    rows = tmeta.total_rows
    assert all(dtt[b * rows:(b + 1) * rows].abs().sum() > 0
               for b in range(4))
    none_dx, dtt2 = TB.brick_encode_bwd_xla_batched(
        _t(x), _t(table), _t(g), tmeta, _t(bidx), need_dx=False)
    assert none_dx is None and torch.equal(dtt2, dtt)


def test_brick_nablas_bwd_batched_matches_jax_second_order():
    """The nablas' backward against `jax.grad` of a loss on
    `brick_nablas_batched` (off the TPU its vjp of the plain encode's
    vjp), in g_up, x and the table; and the port's wrappers to second
    order on CPU tensors (plain autograd)."""
    jmeta, tmeta, x, table, bidx, g, gg = _inputs(300, 5, 2)

    def loss(gu, xx, tt):
        n = JB.brick_nablas_batched(gu, xx, tt, jmeta, jnp.asarray(bidx))
        return jnp.sum(n * jnp.asarray(gg))

    dgj, dxj, dtj = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(g), jnp.asarray(x), jnp.asarray(table))
    dgt, dxt, dtt = TB.brick_nablas_bwd_xla_batched(
        _t(g), _t(x), _t(table), _t(gg), tmeta, _t(bidx))
    for a, b in ((dgt, dgj), (dxt, dxj), (dtt, dtj)):
        _close(a, np.asarray(b))
    # the wrappers on CPU tensors: autograd through the plain versions
    gu, xx, tt = (_t(a).requires_grad_(True) for a in (g, x, table))
    n = TB.brick_nablas_batched(gu, xx, tt, tmeta, _t(bidx))
    got = torch.autograd.grad((n * _t(gg)).sum(), (gu, xx, tt))
    for a, b in zip(got, (dgt, dxt, dtt)):
        _close(a, b.numpy())


def test_batched_encode_second_order_on_cpu():
    """`brick_encode_batched` on CPU tensors differentiates twice: the
    gradient in x of a loss on its x-gradient equals JAX's."""
    jmeta, tmeta, x, table, bidx, g, gg = _inputs(200, 4, 3)

    def inner(xx, tt):
        _, vjp = jax.vjp(lambda x_: JB.brick_encode_batched(
            x_, tt, jmeta, jnp.asarray(bidx)), xx)
        return jnp.sum(vjp(jnp.asarray(g))[0] * jnp.asarray(gg))

    dtj = jax.grad(inner, argnums=1)(jnp.asarray(x), jnp.asarray(table))
    xx = _t(x).requires_grad_(True)
    tt = _t(table).requires_grad_(True)
    y = TB.brick_encode_batched(xx, tt, tmeta, _t(bidx))
    (gx,) = torch.autograd.grad(y, xx, _t(g), create_graph=True)
    (dtt,) = torch.autograd.grad((gx * _t(gg)).sum(), tt)
    _close(dtt, np.asarray(dtj))


# ------------------------------------------------------ the train step
CFG = dict(
    space_cfg={"resolution": (2, 2, 2), "origin": (-1.0, -1.0, -1.0),
               "block_size": 1.0},
    field_cfg={"surface_cfg": {
        "lotd_cfg": {"lod_res": [8, 16], "lod_n_feats": 2,
                     "lod_types": ["Dense", "Hash"],
                     "hashmap_size": 2 ** 12, "backend": "brick"},
        "decoder_cfg": {"D": 1, "W": 16}},
        "radiance_cfg": {"D": 2, "W": 16}},
    n_march_steps=32, march_mode="segments", max_segments=4,
    steps_per_segment=8)


@pytest.fixture(scope="module")
def forest():
    jm = JaxForest(**CFG)
    flat = {"/".join(map(str, k)): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(jm))}
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
    tm = TorchForest(**CFG, device="cpu")
    tm.load_state_dict(forest_from_jax_state(flat))
    return jm, tm


def _flat(tree) -> dict:
    return {"/".join(map(str, k)): np.asarray(v[...])
            for k, v in nnx.to_flat_state(tree)}


def _uniforms(key, n_imp: int = 16, rounds: int = 2):
    """The forest query's draws in its key split order (the march's, then
    one per upsample round), as a `draw`."""
    key, km = jax.random.split(key)
    us = [jax.random.uniform(km, (N_RAYS, 4, 8), jnp.float32)]
    for _ in range(rounds):
        key, ki = jax.random.split(key)
        us.append(jax.random.uniform(ki, (N_RAYS, n_imp), jnp.float32,
                                     minval=1e-8, maxval=1.0 - 1e-8))
    it = iter([_t(u) for u in us])

    def draw(shape, lo, hi):
        u = next(it)
        assert tuple(u.shape) == tuple(shape)
        return u
    return draw


def _torch_loss(tm, o, d, draw):
    """examples/train_forest_street.py:121-127 in the port."""
    rendered, vb = tm.ray_query(tm.ray_test(o, d), draw=draw)
    eik = torch.mean((torch.linalg.norm(vb["nablas_packed"], dim=-1)
                      - 1.0) ** 2)
    rgb_l = torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2)
    return rgb_l + 0.01 * eik, vb


def test_forest_train_step_matches_jax(forest):
    """One step of the example's `train_step`, eager JAX against the
    port on the CPU: the loss, every parameter's gradient, then the
    parameters after Adam(1e-2) against optax."""
    jm, tm = forest
    o, d = _rays(N_RAYS, 21)
    key = jax.random.key(22)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p):
        m = nnx.merge(graphdef, p, rest)
        oo, dd = jnp.asarray(o), jnp.asarray(d)
        rendered, vb = m.ray_query(m.ray_test(oo, dd), key=key)
        eik = jnp.mean((jnp.linalg.norm(vb["nablas_packed"], axis=-1)
                        - 1.0) ** 2)
        return jnp.mean((rendered["rgb_volume"] - jnp.abs(dd)) ** 2) \
            + 0.01 * eik

    jl, jg = jax.value_and_grad(loss_fn)(params)
    opt = optax.adam(LR)
    upd, _ = opt.update(jg, opt.init(params))
    jp = optax.apply_updates(params, upd)

    tm.zero_grad(set_to_none=True)
    tl, vb = _torch_loss(tm, _t(o), _t(d), _uniforms(key))
    assert int(vb["n_compact"]) > N_RAYS
    assert int((vb["ridx"] == N_RAYS).sum()) > 0      # padding slots
    tl.backward()
    rel = abs(float(tl.detach()) - float(jl)) / abs(float(jl))
    assert rel <= 1e-4, rel
    jgrads = _flat(jg)
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(jgrads)
    errs = {k: float(np.linalg.norm(got[k] - jgrads[k]) /
                     max(np.linalg.norm(jgrads[k]), 1e-12)) for k in got}
    assert max(errs.values()) <= 1e-2, errs
    enc = tm.field.implicit_surface.encoding.flattened_params
    assert (enc.grad.abs().sum(-1) > 0).all()          # every block
    # one Adam step: from the port's gradients, within 1e-2 of a step (lr)
    # of optax's from JAX's (the gradients' standard carried through);
    # from JAX's gradients, within 1e-7 (the same update)
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    want = _flat(jp)
    for grads in (None, jgrads):
        with torch.no_grad():
            for k, p in tm.named_parameters():
                p.copy_(before[k])
                if grads is not None:
                    p.grad = _t(grads[k.replace(".", "/")])
        torch.optim.Adam(tm.parameters(), lr=LR).step()
        after = to_jax_paths(dict(tm.named_parameters()))
        for k, v in want.items():
            np.testing.assert_allclose(
                after[k], v, rtol=0, atol=1e-2 * LR if grads is None
                else 1e-7, err_msg=k)
    with torch.no_grad():                 # leave the module's model as it was
        for k, p in tm.named_parameters():
            p.copy_(before[k])


def test_forest_trains_on_cpu(forest):
    """Eight steps of the example's loop on the CPU port (the lifecycle
    every `lifecycle_update_every` steps, no stepwise schedule): the loss
    falls."""
    _, tm0 = forest
    tm = TorchForest(**CFG, device="cpu")
    tm.load_state_dict(tm0.state_dict())
    assert not tm.has_stepwise_schedules()
    every = tm.lifecycle_update_every
    opt = torch.optim.Adam(tm.parameters(), lr=LR)
    gen = torch.Generator().manual_seed(3)
    o, d = (_t(a) for a in _rays(N_RAYS, 23))
    losses = []
    for it in range(8):
        if it % every == 0:
            tm.training_before_per_step(it, gen)
        opt.zero_grad(set_to_none=True)
        loss, _ = _torch_loss(tm, o, d, None)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0], losses


# ---------------------------------------------- the space's populates
def _space_pair(res=(6, 4, 5), block_size=0.5):
    kw = dict(resolution=res, origin=(-1.5, -1.0, -1.2),
              block_size=block_size)
    return JaxSpace(**kw), TorchSpace(**kw, device="cpu")


def _same_blocks(js, ts):
    assert ts.n_trees == js.n_trees > 0
    np.testing.assert_array_equal(ts.occupied.numpy(),
                                  np.asarray(js.occupied[...]))
    np.testing.assert_array_equal(ts.block_idx.numpy(),
                                  np.asarray(js.block_idx[...]))


def test_populate_from_waypoints_matches_jax():
    js, ts = _space_pair()
    w = np.stack([np.linspace(-1.4, 1.4, 9), np.sin(np.linspace(0, 3, 9))
                  * 0.5, np.linspace(-0.5, 0.9, 9)], -1).astype(np.float32)
    js.populate_from_waypoints(w, extend_units=1)
    ts.populate_from_waypoints(w, extend_units=1)
    _same_blocks(js, ts)
    assert ts.n_trees < int(np.prod(ts.resolution))


@pytest.mark.parametrize("dilate", [0, 1])
def test_populate_from_mesh_matches_jax(dilate):
    js, ts = _space_pair()
    rng = np.random.default_rng(31)
    verts = rng.uniform(-1.0, 1.0, (12, 3)).astype(np.float32)
    faces = rng.integers(0, 12, (10, 3))
    js.populate_from_mesh(verts, faces, samples_per_area=16.0,
                          dilate=dilate, seed=4)
    ts.populate_from_mesh(verts, faces, samples_per_area=16.0,
                          dilate=dilate, seed=4)
    _same_blocks(js, ts)


def test_populate_from_pinhole_cameras_matches_jax():
    js, ts = _space_pair(res=(8, 8, 8), block_size=0.4)
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2w[0, :3, 3] = [0.0, 0.0, -1.5]
    c2w[1, :3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    c2w[1, :3, 3] = [-1.5, 0.2, 0.0]
    k = np.asarray([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]], np.float32)
    intrs = np.stack([k, k])
    js.populate_from_pinhole_cameras(c2w, intrs, (48, 64), 0.2, 2.5,
                                     n_samples_per_cam=2048, seed=5)
    ts.populate_from_pinhole_cameras(c2w, intrs, (48, 64), 0.2, 2.5,
                                     n_samples_per_cam=2048, seed=5)
    _same_blocks(js, ts)


# ---------------------------- the forest accel, the batched march
def test_forest_collect_samples_and_debug_stats_match_jax(forest):
    from nr3d_lib_tpu.models.accelerations.occgrid_forest import \
        OccGridAccelForest as JaxAccel
    from nr3d_lib_tpu_torch.models.accelerations.occgrid_forest import \
        OccGridAccelForest as TorchAccel

    jm, tm = forest
    ja = JaxAccel(jm.space, resolution=(8, 8, 8))
    ta = TorchAccel(tm.space, resolution=(8, 8, 8), device="cpu")
    ja.occ.val_grid[...] = jnp.zeros_like(ja.occ.val_grid[...])
    ta.occ.val_grid.zero_()
    rng = np.random.default_rng(32)
    x = rng.uniform(-1.2, 1.2, (3000, 3)).astype(np.float32)
    vals = rng.normal(size=3000).astype(np.float32) * 0.05
    ja.collect_samples(jnp.asarray(x), jnp.asarray(vals))
    ta.collect_samples(_t(x), _t(vals))
    np.testing.assert_array_equal(ta.occ.val_grid.numpy(),
                                  np.asarray(ja.occ.val_grid[...]))
    assert ta.debug_stats() == ja.debug_stats()
    assert 0 < ta.debug_stats()["n_occupied"] < ta.occ.val_grid.numel()


def _batched_grid_and_rays(seed: int, n: int = 100, b: int = 3):
    rng = np.random.default_rng(seed)
    occ = rng.uniform(size=(b, 8, 8, 8)) < 0.4
    o, d = _rays(n, seed + 1, radius=1.8)
    o, d = o / 1.2, d
    bidx = rng.integers(-1, b, n).astype(np.int32)
    return occ, o, d, bidx


@pytest.mark.parametrize("perturb", [False, True])
def test_occgrid_raymarch_batched_matches_jax(perturb):
    from nr3d_lib_tpu.graphics import raymarch as JR
    from nr3d_lib_tpu.graphics.raytest import ray_box_intersection as jrbi
    from nr3d_lib_tpu_torch.graphics import raymarch as TR
    from nr3d_lib_tpu_torch.ops.occgrid_march import \
        occgrid_march_batched_dense

    occ, o, d, bidx = _batched_grid_and_rays(33)
    near, far, _ = jrbi(jnp.asarray(o), jnp.asarray(d), -1.0, 1.0)
    key = jax.random.key(34) if perturb else None
    kw = dict(n_steps=48, step_size=2.0 / 40)
    rj = JR.occgrid_raymarch_batched(jnp.asarray(occ), jnp.asarray(bidx),
                                     jnp.asarray(o), jnp.asarray(d), near,
                                     far, perturb_key=key, **kw)
    u = _t(jax.random.uniform(key, (len(o), 48), jnp.float32)) \
        if perturb else None
    rt = TR.occgrid_raymarch_batched(_t(occ), _t(bidx), _t(o), _t(d),
                                     _t(near), _t(far), u=u, **kw)
    assert isinstance(rt, TR.RaymarchRetBatched)
    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(rt.dt.numpy(), np.asarray(rj.dt), rtol=0,
                               atol=1e-6)
    assert torch.equal(rt.bidx, _t(bidx))
    assert int(rt.num_hit_samples) == int(rj.num_hit_samples) > 0
    t2, dt2, m2 = occgrid_march_batched_dense(
        _t(occ).float(), _t(bidx), _t(o), _t(d), _t(near), _t(far), u=u,
        **kw)
    assert torch.equal(m2, rt.mask)
    # the packed form
    tf, dtf, ridx = rt.to_packed()
    tfj, dtfj, ridxj = rj.to_packed()
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(ridxj))
    np.testing.assert_allclose(tf.numpy(), np.asarray(tfj), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(dtf.numpy(), np.asarray(dtfj), rtol=0,
                               atol=1e-6)


def test_occgrid_raymarch_matches_jax():
    from nr3d_lib_tpu.graphics import raymarch as JR
    from nr3d_lib_tpu.graphics.raytest import ray_box_intersection as jrbi
    from nr3d_lib_tpu_torch.graphics import raymarch as TR

    occ, o, d, _ = _batched_grid_and_rays(35, b=1)
    near, far, _ = jrbi(jnp.asarray(o), jnp.asarray(d), -1.0, 1.0)
    kw = dict(n_steps=48, step_size=2.0 / 40)
    rj = JR.occgrid_raymarch(jnp.asarray(occ[0]), jnp.asarray(o),
                             jnp.asarray(d), near, far, **kw)
    rt = TR.occgrid_raymarch(_t(occ[0]), _t(o), _t(d), _t(near), _t(far),
                             **kw)
    assert isinstance(rt, TR.RaymarchRetSingle)
    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), rtol=0,
                               atol=1e-6)
    x = rt.positions(_t(o), _t(d))
    np.testing.assert_allclose(
        x.numpy(), np.asarray(rj.positions(jnp.asarray(o), jnp.asarray(d))),
        rtol=0, atol=1e-6)
    cap = 40 * len(o)
    tf, _, ridx = rt.to_packed(cap)
    tfj, _, ridxj = rj.to_packed(cap)
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(ridxj))
    np.testing.assert_allclose(tf.numpy(), np.asarray(tfj), rtol=0,
                               atol=1e-6)
