"""Port parity: occupancy lookup, marching and budget compaction
(nr3d_lib_tpu_torch.ops.gather1d / occgrid_march, graphics.pack_ops,
models.accelerations) against the JAX package on the CPU.

All of these are exact: lookups and masks are equal, and compaction moves
values without arithmetic, so they are compared for equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nr3d_lib_tpu.graphics import pack_ops as jpo
from nr3d_lib_tpu.ops import gather1d as jg
from nr3d_lib_tpu.ops import occgrid_march as jom
from nr3d_lib_tpu_torch.graphics import pack_ops as tpo
from nr3d_lib_tpu_torch.ops import gather1d as tg
from nr3d_lib_tpu_torch.ops import occgrid_march as tom

torch.set_num_threads(1)


def _rays(n: int, seed: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_gather_rows_lanes_matches_jax():
    rng = np.random.default_rng(0)
    values = rng.standard_normal((256, 64)).astype(np.float32)
    row = rng.integers(0, 256, (3000,)).astype(np.int32)
    lane = rng.integers(0, 64, (3000,)).astype(np.int32)
    row[:4] = [-1, 300, 255, 0]         # clipped like the JAX fallback
    lane[:4] = [0, 70, 63, -5]
    row, lane = row.reshape(30, 100), lane.reshape(30, 100)
    vj = np.asarray(jg.gather_rows_lanes(jnp.asarray(values), jnp.asarray(row),
                                         jnp.asarray(lane)))
    vt = tg.gather_rows_lanes(torch.from_numpy(values), torch.from_numpy(row),
                              torch.from_numpy(lane))
    assert vt.shape == (30, 100)
    np.testing.assert_array_equal(vt.numpy(), vj)


def test_march_mask_and_query_match_jax():
    rng = np.random.default_rng(1)
    occ = rng.uniform(size=(16, 16, 16)) < 0.5
    o, d = _rays(128, 2)
    from nr3d_lib_tpu.graphics.raytest import ray_box_intersection as jbox
    from nr3d_lib_tpu_torch.graphics.raytest import ray_box_intersection as tbox

    nj, fj, hj = (np.asarray(a) for a in jbox(jnp.asarray(o), jnp.asarray(d),
                                              -1.0, 1.0))
    nt, ft, ht = tbox(torch.from_numpy(o), torch.from_numpy(d),
                      torch.full((3,), -1.0), torch.full((3,), 1.0))
    np.testing.assert_array_equal(nt.numpy(), nj)
    np.testing.assert_array_equal(ft.numpy(), fj)
    np.testing.assert_array_equal(ht.numpy(), hj)
    tj, dtj, mj = jom.occgrid_march_dense(
        jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d), jnp.asarray(nj),
        jnp.asarray(fj), n_steps=32, step_size=2.0 / 32)
    tt, dtt, mt = tom.occgrid_march_dense(
        torch.from_numpy(occ), torch.from_numpy(o), torch.from_numpy(d), nt, ft,
        n_steps=32, step_size=2.0 / 32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(dtt.numpy(), np.asarray(dtj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0 < mt.sum() < mt.numel()
    # geometric step growth, clamped
    for a, b in zip(tom.march_steps(nt, ft, 32, 0.02, dt_gamma=0.1,
                                    max_step_size=0.1),
                    jom.march_steps(jnp.asarray(nj), jnp.asarray(fj), 32,
                                    0.02, dt_gamma=0.1, max_step_size=0.1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    x = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tom.occgrid_query(torch.from_numpy(occ), torch.from_numpy(x)).numpy(),
        np.asarray(jom.occgrid_query(jnp.asarray(occ), jnp.asarray(x))))


@pytest.mark.parametrize("budget", [1, 7, 16, 40])
def test_budget_compaction_matches_jax(budget):
    rng = np.random.default_rng(budget)
    mask = rng.uniform(size=(64, 32)) < 0.4
    mask[0] = False
    mask[1] = True
    t = rng.standard_normal((64, 32)).astype(np.float32)
    ints = rng.integers(-2 ** 31, 2 ** 31 - 1, (64, 32)).astype(np.int32)
    vec = rng.standard_normal((64, 32, 3)).astype(np.float32)
    (jt, ji, jb, jv), jvalid = jpo.dense_to_budgeted(
        [jnp.asarray(t), jnp.asarray(ints), jnp.asarray(mask),
         jnp.asarray(vec)], jnp.asarray(mask), budget)
    (tt, ti, tb, tv), tvalid = tpo.dense_to_budgeted(
        [torch.from_numpy(t), torch.from_numpy(ints), torch.from_numpy(mask),
         torch.from_numpy(vec)], torch.from_numpy(mask), budget)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    for a, b in ((tt, jt), (ti, ji), (tb, jb), (tv, jv)):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jidx, jval = jpo.budget_indices(jnp.asarray(mask), budget)
    tidx, tval = tpo.budget_indices(torch.from_numpy(mask), budget)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))


def test_occgrid_init_from_net_matches_jax():
    from nr3d_lib_tpu.models.accelerations.occgrid import OccGridEma as JO
    from nr3d_lib_tpu.models.accelerations.occgrid import \
        cell_centers as jcc
    from nr3d_lib_tpu_torch.models.accelerations import OccGridEma as TO
    from nr3d_lib_tpu_torch.models.accelerations import cell_centers as tcc

    res = (8, 12, 16)
    np.testing.assert_array_equal(tcc(res).numpy(), np.asarray(jcc(res)))
    jo, to = JO(res), TO(res)
    jo.init_from_net(None, lambda x: jnp.sum(x * x, -1) - 0.5, chunk=500)
    to.init_from_net(lambda x: torch.sum(x * x, -1) - 0.5, chunk=500)
    np.testing.assert_allclose(to.val_grid.numpy(), np.asarray(jo.val_grid[...]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(to.occ().numpy(), np.asarray(jo.occ()))
