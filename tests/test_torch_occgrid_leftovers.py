"""Port parity: the occupancy leftovers (ROADMAP A7c) against the JAX
package on the CPU, at a small size.

* `OccGridEma`: `occupancy_ratio`, `query`, `collect_samples` (points
  outside the grid and repeated cells included) and `try_shrink` (an
  empty grid included).
* `OccGridGetter`: the bool grid, `update` in one chunk and in several.
* `OccGridAccel` at `use_ema=False`: `init`, `step` off and on its
  interval, `collect_samples` (ignored), `query`, `try_shrink` (None)
  and `debug_stats`; at `use_ema=True` the same methods over the EMA
  grid; `get_accel("occ_grid_getter")`.
* `AABBSpace`: `scale`, `normalize_coords`, `unnormalize_coords`,
  `rescale_volume` (in place) and `sample_pts_uniform` (by its law:
  `jax.random` cannot be reproduced in torch).
* `LoTDNeuSModel(accel_cfg={"use_ema": False})` at F=4 (the
  examples/train_neus_object.py --w4 model at a small width): populate's
  getter grid, the occupancy update of `training_before_per_step(0)`,
  the render with JAX's draws replayed and one example step (MSE +
  0.03·eikonal, clip 5, Adam(3e-3)) with `test_torch_query_modes`'s
  helpers.

Tolerances: the grids, the queries, the collected values, the shrunk
box and the stats are held bitwise (integer counts, maxima, thresholds,
exact quotients). The coordinate maps within 1e-6. The model's grid from
the field's values: every cell equal except where the value lies within
1e-5 of the threshold (the port's and JAX's field sum in other orders);
the render and the step to PERF.md §2's standard (as
`test_torch_query_modes.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.accelerations import get_accel as jget_accel
from nr3d_lib_tpu.models.accelerations.occgrid import OccGridEma as JEma
from nr3d_lib_tpu.models.accelerations.occgrid import \
    OccGridGetter as JGetter
from nr3d_lib_tpu.models.accelerations.occgrid_accel import \
    OccGridAccel as JAccel
from nr3d_lib_tpu.models.model_base import LoTDNeuSModel as JaxNeuS
from nr3d_lib_tpu.models.spatial.aabb import AABBSpace as JSpace
from nr3d_lib_tpu_torch.bridge import from_jax_state
from nr3d_lib_tpu_torch.models.accelerations import get_accel
from nr3d_lib_tpu_torch.models.accelerations.occgrid import (OccGridEma,
                                                            OccGridGetter)
from nr3d_lib_tpu_torch.models.accelerations.occgrid_accel import \
    OccGridAccel
from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel as TorchNeuS
from nr3d_lib_tpu_torch.models.spatial.aabb import AABBSpace
from nr3d_lib_tpu_torch.bridge import to_jax_paths
from nr3d_lib_tpu_torch.models.utils import clip_by_global_norm_
from test_torch_query_modes import (LR, MUP, _example_loss, _flat,
                                    _grad_errors, _jax_render, _mup_uniforms,
                                    _neus_cfg, _rays, _render_close, _replay)

torch.set_num_threads(1)

RES = (8, 6, 10)


def _vals(seed: int, shape=RES):
    """Values around the default threshold 0.01: about half occupied."""
    return np.random.default_rng(seed).uniform(0.0, 0.02, shape).astype(
        np.float32)


def _points(n: int, seed: int):
    """Points in [-1.2, 1.2]^3 (some outside the grid) and signed values."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    v = rng.normal(scale=0.05, size=n).astype(np.float32)
    return x, v


def _ema_pair(seed: int):
    j, t = JEma(RES), OccGridEma(RES, device="cpu")
    j.val_grid[...] = jnp.asarray(_vals(seed))
    t.val_grid.copy_(torch.from_numpy(_vals(seed)))
    return j, t


def _sphere_val(lib):
    """A field value on a sphere shell: |value| > 0.01 near |x| = 0.5."""
    def f(x):
        norm = lib.linalg.norm(x, axis=-1) if lib is jnp else \
            torch.linalg.norm(x, dim=-1)
        return 0.02 - 0.02 * lib.abs(norm - 0.5)
    return f


# ------------------------------------------------------------ OccGridEma
def test_ema_ratio_query_shrink_match_jax():
    j, t = _ema_pair(0)
    assert float(t.occupancy_ratio()) == float(j.occupancy_ratio())
    x, _ = _points(500, 1)
    np.testing.assert_array_equal(t.query(torch.from_numpy(x)).numpy(),
                                  np.asarray(j.query(jnp.asarray(x))))
    np.testing.assert_array_equal(t.try_shrink().numpy(),
                                  np.asarray(j.try_shrink()))


def test_ema_try_shrink_tight_and_empty_match_jax():
    vals = np.zeros(RES, np.float32)
    vals[2:5, 1, 3:9] = 1.0
    for v in (vals, np.zeros(RES, np.float32)):
        j, t = JEma(RES), OccGridEma(RES, device="cpu")
        j.val_grid[...] = jnp.asarray(v)
        t.val_grid.copy_(torch.from_numpy(v))
        got, want = t.try_shrink().numpy(), np.asarray(j.try_shrink())
        assert got.dtype == np.float32 and got.shape == (2, 3)
        np.testing.assert_array_equal(got, want)


def test_ema_collect_samples_matches_jax():
    j, t = _ema_pair(2)
    x, v = _points(4000, 3)          # repeated cells, some outside
    x[:50] = x[50:100]               # the same cells hit twice
    j.collect_samples(jnp.asarray(x), jnp.asarray(v))
    t.collect_samples(torch.from_numpy(x), torch.from_numpy(v))
    np.testing.assert_array_equal(t.val_grid.numpy(),
                                  np.asarray(j.val_grid[...]))
    assert float(t.occupancy_ratio()) > float(_ema_pair(2)[1]
                                              .occupancy_ratio())


def test_ema_collect_samples_order_independent():
    _, t = _ema_pair(2)
    _, t2 = _ema_pair(2)
    x, v = _points(4000, 3)
    perm = np.random.default_rng(4).permutation(4000)
    t.collect_samples(torch.from_numpy(x), torch.from_numpy(v))
    t2.collect_samples(torch.from_numpy(x[perm]), torch.from_numpy(v[perm]))
    assert torch.equal(t.val_grid, t2.val_grid)


# --------------------------------------------------------- OccGridGetter
@pytest.mark.parametrize("chunk", [2 ** 16, 97])
def test_getter_update_matches_jax(chunk):
    j, t = JGetter(RES), OccGridGetter(RES, device="cpu")
    assert t.occ_grid.dtype == torch.bool and bool(t.occ_grid.all())
    j.update(_sphere_val(jnp), chunk=chunk)
    t.update(_sphere_val(torch), chunk=chunk)
    got = t.occ().numpy()
    np.testing.assert_array_equal(got, np.asarray(j.occ()))
    assert 0.05 < got.mean() < 0.95


# ---------------------------------------------------------- OccGridAccel
@pytest.mark.parametrize("use_ema", [False, True], ids=["getter", "ema"])
def test_accel_methods_match_jax(use_ema):
    kw = dict(resolution=RES, update_every=4, use_ema=use_ema)
    j, t = JAccel(None, **kw), OccGridAccel(**kw, device="cpu")
    assert isinstance(t.occ, OccGridEma if use_ema else OccGridGetter)
    j.init(jax.random.key(0), _sphere_val(jnp))
    t.init(_sphere_val(torch))
    gen = torch.Generator().manual_seed(0)
    grid = (lambda a: a.occ.val_grid) if use_ema else \
        (lambda a: a.occ.occ_grid)
    np.testing.assert_array_equal(grid(t).numpy(), np.asarray(grid(j)[...]))
    # off the interval nothing moves; on it the getter re-queries
    before = grid(t).clone()
    t.step(3, gen, lambda x: torch.zeros(x.shape[0]))
    assert torch.equal(grid(t), before)
    if not use_ema:
        j.step(4, jax.random.key(1), lambda x: 0.5 * _sphere_val(jnp)(x))
        t.step(4, gen, lambda x: 0.5 * _sphere_val(torch)(x))
        np.testing.assert_array_equal(grid(t).numpy(),
                                      np.asarray(grid(j)[...]))
    x, v = _points(2000, 6)
    j.collect_samples(jnp.asarray(x), jnp.asarray(v))
    t.collect_samples(torch.from_numpy(x), torch.from_numpy(v))
    np.testing.assert_array_equal(grid(t).numpy(), np.asarray(grid(j)[...]))
    np.testing.assert_array_equal(t.query(torch.from_numpy(x)).numpy(),
                                  np.asarray(j.query(jnp.asarray(x))))
    shrink = t.try_shrink()
    if use_ema:
        np.testing.assert_array_equal(shrink.numpy(),
                                      np.asarray(j.try_shrink()))
    else:
        assert shrink is None and j.try_shrink() is None
    assert t.debug_stats() == j.debug_stats()


def test_get_accel_getter():
    a = get_accel("occ_grid_getter", resolution=4, device="cpu")
    ja = jget_accel("occ_grid_getter", resolution=4)
    assert not a.use_ema and not ja.use_ema
    assert isinstance(a.occ, OccGridGetter)
    assert tuple(a.occ.occ_grid.shape) == tuple(ja.occ.occ_grid[...].shape)


# -------------------------------------------------------------- AABBSpace
def test_aabb_coords_and_rescale_match_jax():
    aabb = np.asarray([[-1.0, -2.0, 0.5], [3.0, 0.0, 1.5]], np.float32)
    j, t = JSpace(aabb), AABBSpace(aabb, device="cpu")
    x = np.random.default_rng(7).uniform(-3, 3, (64, 3)).astype(np.float32)
    for name in ("normalize_coords", "unnormalize_coords"):
        np.testing.assert_allclose(
            getattr(t, name)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(j, name)(jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    buf = t.aabb
    new = np.asarray([[-0.5, -0.5, -0.5], [0.25, 0.5, 1.0]], np.float32)
    t.rescale_volume(torch.from_numpy(new))
    j.rescale_volume(jnp.asarray(new))
    assert t.aabb is buf                                    # in place
    np.testing.assert_array_equal(t.aabb.numpy(), np.asarray(j.aabb[...]))
    np.testing.assert_allclose(
        t.normalize_coords(torch.from_numpy(x)).numpy(),
        np.asarray(j.normalize_coords(jnp.asarray(x))), rtol=0, atol=1e-6)
    rt = t.ray_test(torch.zeros(2, 3) - 2.0, torch.ones(2, 3),
                    return_rays=False)
    assert "rays_o" not in rt and "near" in rt


def test_aabb_sample_pts_uniform_law():
    aabb = np.asarray([[-1.0, -2.0, 0.5], [3.0, 0.0, 1.5]], np.float32)
    t = AABBSpace(aabb, device="cpu")
    jx = np.asarray(JSpace(aabb).sample_pts_uniform(
        20000, jax.random.key(0)))
    x = t.sample_pts_uniform(20000, torch.Generator().manual_seed(0))
    assert x.shape == (20000, 3) and x.dtype == torch.float32
    assert torch.equal(x, t.sample_pts_uniform(
        20000, torch.Generator().manual_seed(0)))
    x = x.numpy()
    for pts in (x, jx):
        assert (pts >= aabb[0]).all() and (pts <= aabb[1]).all()
        # the mean of U(lo, hi) within 5 standard errors
        se = (aabb[1] - aabb[0]) / np.sqrt(12 * 20000)
        assert (np.abs(pts.mean(0) - aabb.mean(0)) < 5 * se).all()


# ------------------------------------- the getter NeuS model (--w4 small)
GETTER_CFG = dict(_neus_cfg(4, MUP), accel_cfg=dict(
    _neus_cfg(4, MUP)["accel_cfg"], use_ema=False))
TABLE = "field/implicit_surface/encoding/flattened_params"


@pytest.fixture(scope="module")
def getter_pair():
    """The JAX getter model with its table at ±0.1 and ln_s at ln(64)/10,
    populated; the port model from its state (the grid included)."""
    jm = JaxNeuS(**GETTER_CFG)
    flat = _flat(nnx.state(jm))
    flat[TABLE] = np.random.default_rng(0).uniform(
        -0.1, 0.1, flat[TABLE].shape).astype(np.float32)
    flat["field/var_ctrl/ln_s"] = np.asarray(np.log(64.0) / 10.0,
                                             np.float32)
    state = nnx.state(jm)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(jm, state)
    jm.populate()
    tm = TorchNeuS(**GETTER_CFG, device="cpu")
    assert set(tm.state_dict()) == {k.replace("/", ".") for k in flat}
    tm.load_state_dict(from_jax_state(_flat(nnx.state(jm))))
    return jm, tm


def _near_threshold(tm, thre: float = 0.01, band: float = 1e-5):
    from nr3d_lib_tpu_torch.models.accelerations.occgrid import cell_centers

    with torch.no_grad():
        v = tm.query_occ_val(cell_centers(tm.accel.occ.resolution))
    return (torch.abs(v.abs() - thre) < band).reshape(
        tm.accel.occ.resolution).numpy()


def test_getter_model_grid_matches_jax(getter_pair):
    jm, tm = getter_pair
    assert tm.state_dict()["accel.occ.occ_grid"].dtype == torch.bool
    want = np.asarray(jm.accel.occ.occ_grid[...])
    assert 0.02 < want.mean() < 0.98          # populate left a real grid
    fresh = TorchNeuS(**GETTER_CFG, device="cpu")
    sd = tm.state_dict()
    sd["accel.occ.occ_grid"] = torch.ones_like(sd["accel.occ.occ_grid"])
    fresh.load_state_dict(sd)
    fresh.populate()
    got = fresh.accel.occ.occ_grid.numpy()
    near = _near_threshold(fresh)
    assert ((got == want) | near).all()
    # the update of training_before_per_step(0): the same re-query
    fresh.accel.occ.occ_grid.fill_(True)
    fresh.training_before_per_step(0)
    assert ((fresh.accel.occ.occ_grid.numpy() == want) | near).all()
    fresh.accel.occ.occ_grid.fill_(True)
    fresh.training_before_per_step(1)               # off the interval
    assert bool(fresh.accel.occ.occ_grid.all())
    assert fresh.accel.try_shrink() is None
    stats = fresh.accel.debug_stats()
    assert stats["n_occupied"] == want.size


def test_getter_model_render_matches_jax(getter_pair):
    jm, tm = getter_pair
    o, d = _rays(512, 1)
    key = jax.random.key(2)
    rj = _jax_render(jm, o, d, key)
    with torch.no_grad():
        rt, _ = tm.ray_query(tm.ray_test(torch.from_numpy(o),
                                         torch.from_numpy(d)),
                             draw=_replay(_mup_uniforms(key, 512)))
    _render_close(rt, rj)


def test_getter_model_step_matches_jax(getter_pair):
    """The example's step: the loss and every gradient against
    `jax.value_and_grad`; then clip(5) + Adam(3e-3) from JAX's gradients
    against optax's parameters. (From the port's own gradients Adam's
    first update, ≈ lr·sign(g) entry by entry, moves the table entries
    whose gradients are near zero by ±lr on a last-ulp difference; the
    update is therefore held from JAX's gradients.)"""
    jm, tm = getter_pair
    o, d = _rays(128, 4)
    key = jax.random.key(5)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p, oo, dd):
        m = nnx.merge(graphdef, p, rest)
        rendered, vb = m.ray_query(m.ray_test(oo, dd), key=key)
        return _example_loss(rendered, vb, dd)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(o), jnp.asarray(d))
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(LR))
    upd, _ = opt.update(jg, opt.init(params))
    want = _flat(optax.apply_updates(params, upd))
    jgrads = _flat(jg)

    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    try:
        tm.zero_grad(set_to_none=True)
        rendered, vb = tm.ray_query(
            tm.ray_test(torch.from_numpy(o), torch.from_numpy(d)),
            draw=_replay(_mup_uniforms(key, 128)))
        tl = _example_loss(rendered, vb, torch.from_numpy(d))
        tl.backward()
        assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
        errs = _grad_errors(tm, jgrads)
        assert max(errs.values()) <= 1e-2, errs
        with torch.no_grad():
            for k, p in tm.named_parameters():
                p.grad = torch.from_numpy(jgrads[k.replace(".", "/")].copy())
        clip_by_global_norm_(tm.parameters(), 5.0)
        torch.optim.Adam(tm.parameters(), lr=LR).step()
        after = to_jax_paths(dict(tm.named_parameters()))
        for k, v in want.items():
            np.testing.assert_allclose(after[k], v, rtol=0, atol=1e-7,
                                       err_msg=k)
    finally:
        with torch.no_grad():
            for k, p in tm.named_parameters():
                p.copy_(before[k])
                p.grad = None
