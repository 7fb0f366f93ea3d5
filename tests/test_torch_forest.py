"""Port parity: the forest (block-decomposed scenes) against the JAX package
on the CPU: the per-block brick encode and nablas (the plain versions of B6
and B8 with a block row offset), the block space's ray tests and
marching, the per-block occupancy, the packed ops, and the forest NeuS
render (`LoTDForestNeuSModel`, the experiments/bench_render.py
`main_forest` model at a small size: 2×2×2 blocks, `lod_res [8, 16]`,
width 16, 64 rays, weights through the state bridge).

Inputs come from numpy seeds as float32 (the conftest turns on x64).

Tolerances: integer outputs (slots, segment block indices, counts, masks,
ridx) are exact. The slab tests and the marching are the same float32
elementwise operations in both, so their times are held to 1e-6. The
encode and nablas sum eight corner products in another order: 1e-6, and
1e-5 plus 2e-6 relative for the nablas (they carry the level's
resolution: entries up to ~30 at a ±1 table). The packed scans combine
in another tree (float64 here): 1e-6. The forest render passes an SDF
network and NeuS upsampling, which can move a ray's samples on a
last-ulp difference: every ray's rgb, depth, mask and normals within
1e-4 of eager JAX (measured: 3.3e-6 at most), and the packed sample count
and ridx exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.graphics import pack_ops as JP
from nr3d_lib_tpu.models.fields_forest import LoTDForestNeuSModel as JaxForest
from nr3d_lib_tpu.models.spatial.forest import ForestBlockSpace as JaxSpace
from nr3d_lib_tpu.ops import lotd_brick as JB
from nr3d_lib_tpu_torch.bridge import forest_from_jax_state
from nr3d_lib_tpu_torch.graphics import pack_ops as TP
from nr3d_lib_tpu_torch.models.fields_forest import \
    LoTDForestNeuSModel as TorchForest
from nr3d_lib_tpu_torch.models.spatial.forest import \
    ForestBlockSpace as TorchSpace
from nr3d_lib_tpu_torch.ops import lotd_brick as TB

torch.set_num_threads(1)

N_RAYS = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _rays(n: int, seed: int, radius: float = 2.5):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * radius
    d = -o / radius + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


# ------------------------------------------------- per-block encode/nablas
def _batched_inputs(n: int, blocks: int, seed: int):
    lod_res, types = [8, 16, 32], ["Dense", "Dense", "Hash"]
    jmeta = JB.make_forest_meta(JB.make_brick_meta(lod_res, types, 64))
    tmeta = TB.make_forest_meta(TB.make_brick_meta(lod_res, types, 64))
    assert tmeta.total_rows == jmeta.total_rows
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:8] = np.round(x[:8] * 14) / 14            # points on cell faces
    table = rng.uniform(-1, 1, (blocks * tmeta.total_rows, 128)
                        ).astype(np.float32)
    bidx = rng.integers(-1, blocks, n).astype(np.int32)   # −1 reads block 0
    g = rng.normal(size=(n, 2 * tmeta.n_levels)).astype(np.float32)
    return jmeta, tmeta, x, table, bidx, g


def test_brick_encode_batched_matches_jax():
    jmeta, tmeta, x, table, bidx, _ = _batched_inputs(500, 5, 1)
    yj = JB.brick_encode_xla_batched(jnp.asarray(x), jnp.asarray(table),
                                     jmeta, jnp.asarray(bidx))
    yt = TB.brick_encode_batched(_t(x), _t(table), tmeta, _t(bidx))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-6)
    # bidx < 0 reads block 0, as the kernel does (the callers zero it)
    neg = bidx < 0
    y0 = TB.brick_encode_xla(_t(x[neg]), _t(table[:tmeta.total_rows]), tmeta)
    assert neg.any() and torch.equal(yt[_t(neg)], y0)


def test_brick_nablas_batched_matches_jax_vjp():
    jmeta, tmeta, x, table, bidx, g = _batched_inputs(500, 5, 2)
    _, vjp = jax.vjp(lambda xx: JB.brick_encode_xla_batched(
        xx, jnp.asarray(table), jmeta, jnp.asarray(bidx)), jnp.asarray(x))
    (dj,) = vjp(jnp.asarray(g))
    dt = TB.brick_nablas_batched(_t(g), _t(x), _t(table), tmeta, _t(bidx))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=2e-6,
                               atol=1e-5)
    # and the autograd vjp of the port's own plain encode
    xt = _t(x).requires_grad_(True)
    (da,) = torch.autograd.grad(TB.brick_encode_xla_batched(
        xt, _t(table), tmeta, _t(bidx)), xt, _t(g))
    np.testing.assert_allclose(dt.numpy(), da.numpy(), rtol=2e-6, atol=1e-5)


def test_batched_backwards_raise_and_bad_arguments():
    """The batched encode's and nablas' gradients (plain autograd on CPU
    tensors; they raised before the forest train step was ported)
    against JAX's, dL/dtable within 1e-6 and the nablas' within 1e-6 of
    their largest entry; bad arguments still raise."""
    jmeta, tmeta, x, table, bidx, g = _batched_inputs(40, 3, 3)
    tab = _t(table).requires_grad_(True)
    y = TB.brick_encode_batched(_t(x), tab, tmeta, _t(bidx))
    (dt,) = torch.autograd.grad((y * _t(g)).sum(), tab)
    _, vjp = jax.vjp(lambda tt: JB.brick_encode_xla_batched(
        jnp.asarray(x), tt, jmeta, jnp.asarray(bidx)), jnp.asarray(table))
    np.testing.assert_allclose(dt.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=0, atol=1e-6)
    gu = _t(g).requires_grad_(True)
    n = TB.brick_nablas_batched(gu, _t(x), tab, tmeta, _t(bidx))
    got = torch.autograd.grad(n.sum(), (gu, tab))
    want = jax.grad(lambda a, b: jnp.sum(JB.brick_nablas_batched(
        a, jnp.asarray(x), b, jmeta, jnp.asarray(bidx))), argnums=(0, 1))(
        jnp.asarray(g), jnp.asarray(table))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max() + 1e-6)
    with pytest.raises(ValueError, match="bidx"):
        TB.brick_encode_batched(_t(x), _t(table), tmeta,
                                _t(bidx.astype(np.int64)))
    with pytest.raises(ValueError, match="table"):
        TB.brick_encode_batched(_t(x), _t(table[:-1]), tmeta, _t(bidx))


# ------------------------------------------------------------ the space
def _spaces(res, occupied, origin=(-1.0, -1.0, -1.0), block_size=0.25):
    js = JaxSpace(resolution=res, origin=origin, block_size=block_size)
    ts = TorchSpace(resolution=res, origin=origin, block_size=block_size,
                    device="cpu")
    coords = np.argwhere(occupied)
    js.populate_from_corners(coords)
    ts.populate_from_corners(coords)
    return js, ts


@pytest.fixture(scope="module")
def spaces():
    rng = np.random.default_rng(4)
    occ = rng.uniform(size=(8, 8, 8)) < 0.4
    return _spaces((8, 8, 8), occ)


def test_slots_and_point_mapping_match_jax(spaces):
    js, ts = spaces
    assert ts.n_trees == js.n_trees > 0
    np.testing.assert_array_equal(ts.block_idx.numpy(),
                                  np.asarray(js.block_idx[...]))
    np.testing.assert_array_equal(ts.block_coords.numpy(),
                                  np.asarray(js.block_coords))
    for a, b in zip(ts._hier_members, js._hier_members):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(5).uniform(-1.2, 1.2, (1000, 3)
                                         ).astype(np.float32)
    bj = js.block_of_points(jnp.asarray(x))
    bt = ts.block_of_points(_t(x))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert (bt < 0).any() and (bt >= 0).any()
    np.testing.assert_allclose(
        ts.normalize_coords(_t(x), bt).numpy(),
        np.asarray(js.normalize_coords(jnp.asarray(x), bj)), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("hierarchy", [False, True])
def test_ray_test_segments_matches_jax(spaces, hierarchy):
    js, ts = spaces
    o, d = _rays(200, 6, radius=2.0)
    rj = js.ray_test(jnp.asarray(o), jnp.asarray(d))
    rt = ts.ray_test(_t(o), _t(d))
    np.testing.assert_array_equal(rt["mask"].numpy(), np.asarray(rj["mask"]))
    sj = js.ray_test_segments(jnp.asarray(o), jnp.asarray(d), rj["near"],
                              rj["far"], max_segments=12,
                              hierarchy=hierarchy)
    st = ts.ray_test_segments(_t(o), _t(d), rt["near"], rt["far"],
                              max_segments=12, hierarchy=hierarchy)
    for k in ("seg_bidx", "seg_mask", "n_segs", "mask"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]),
                                      err_msg=k)
    for k in ("seg_t_in", "seg_t_out", "near", "far"):
        m = np.isfinite(np.asarray(sj[k]))
        np.testing.assert_array_equal(np.isfinite(st[k].numpy()), m)
        np.testing.assert_allclose(st[k].numpy()[m], np.asarray(sj[k])[m],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert int(st["n_segs"].max()) > 1                 # not vacuous
    # the culling levels find the blocks the dense test finds
    if hierarchy:
        dense = ts.ray_test_segments(_t(o), _t(d), rt["near"], rt["far"],
                                     max_segments=12, hierarchy=False)
        assert torch.equal(dense["seg_bidx"], st["seg_bidx"])


@pytest.mark.parametrize("perturb", [False, True])
def test_march_segments_matches_jax(spaces, perturb):
    js, ts = spaces
    o, d = _rays(100, 7, radius=2.0)
    segs_j = js.ray_test_segments(jnp.asarray(o), jnp.asarray(d),
                                  max_segments=6)
    segs_t = ts.ray_test_segments(_t(o), _t(d), max_segments=6)
    key = jax.random.key(1) if perturb else None
    outs_j = js.march_segments(segs_j, steps_per_segment=5, perturb_key=key)
    u = _t(jax.random.uniform(key, (100, 6, 5), jnp.float32)) \
        if perturb else None
    outs_t = ts.march_segments(segs_t, steps_per_segment=5, u=u)
    mask = np.asarray(outs_j[3])
    np.testing.assert_array_equal(outs_t[3].numpy(), mask)
    np.testing.assert_array_equal(outs_t[2].numpy(), np.asarray(outs_j[2]))
    for a, b in zip(outs_t[:2], outs_j[:2]):
        np.testing.assert_allclose(a.numpy()[mask], np.asarray(b)[mask],
                                   rtol=0, atol=1e-6)
    assert mask.sum() > 100


def test_state_dict_rebuilds_slots(spaces):
    js, ts = spaces
    ts2 = TorchSpace(resolution=(8, 8, 8), origin=(-1.0, -1.0, -1.0),
                     block_size=0.25, device="cpu")
    assert ts2.n_trees == 0
    ts2.load_state_dict(ts.state_dict())
    assert set(ts.state_dict()) == {"origin", "occupied", "block_idx"}
    assert ts2.n_trees == ts.n_trees
    assert torch.equal(ts2.block_coords, ts.block_coords)
    assert torch.equal(ts2.block_idx, ts.block_idx)
    pts = np.random.default_rng(8).uniform(-1, 0, (50, 3))
    js2 = JaxSpace(resolution=(8, 8, 8), origin=(-1.0, -1.0, -1.0),
                   block_size=0.25)
    js2.populate_from_points(pts)
    ts2.populate_from_points(pts)
    np.testing.assert_array_equal(ts2.occupied.numpy(),
                                  np.asarray(js2.occupied[...]))
    assert ts2.n_trees == js2.n_trees


# ---------------------------------------------------------- packed ops
@pytest.mark.parametrize("capacity", [30, 200])
def test_packed_ops_match_jax(capacity):
    """dense_to_packed (a capacity that drops samples and one with padding
    slots), packed alpha → weights, sums and scans: padding (ridx ==
    n_packs) contributes nothing."""
    rng = np.random.default_rng(capacity)
    r, s = 13, 11
    mask = rng.uniform(size=(r, s)) < 0.5
    mask[3] = False                               # an empty pack
    dense = rng.normal(size=(r, s)).astype(np.float32)
    pj, rj = JP.dense_to_packed(jnp.asarray(dense), jnp.asarray(mask),
                                capacity)
    pt, rt = TP.dense_to_packed(_t(dense), _t(mask), capacity)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert rt.dtype == torch.int32
    if capacity > mask.sum():
        assert (rt == r).any()                    # padding slots present
    alpha = rng.uniform(size=capacity).astype(np.float32)
    vj = JP.packed_alpha_to_vw(jnp.asarray(alpha), rj)
    vt = TP.packed_alpha_to_vw(_t(alpha), rt)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=1e-6)
    feats = rng.normal(size=(capacity, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TP.packed_sum(_t(feats), rt, r).numpy(),
        np.asarray(JP.packed_sum(jnp.asarray(feats), rj, r)), rtol=0,
        atol=1e-6)
    for excl in (False, True):
        np.testing.assert_allclose(
            TP.packed_cumprod(_t(alpha), rt, exclusive=excl).numpy(),
            np.asarray(JP.packed_cumprod(jnp.asarray(alpha), rj,
                                         exclusive=excl)), rtol=0, atol=1e-6)
    start = TP.mark_pack_boundaries(rt)
    np.testing.assert_array_equal(start.numpy(),
                                  np.asarray(JP.mark_pack_boundaries(rj)))
    for rev in (False, True):
        np.testing.assert_allclose(
            TP.segmented_scan(_t(feats), start, reverse=rev).numpy(),
            np.asarray(JP.segmented_scan(jnp.asarray(feats),
                                         jnp.asarray(start.numpy()),
                                         reverse=rev)), rtol=0, atol=1e-5)
    keep = rng.uniform(size=capacity) < 0.7
    (cj,), crj = JP.compactify(jnp.asarray(keep), [jnp.asarray(feats)], rj,
                               r, capacity=capacity // 2)
    (ct,), crt = TP.compactify(_t(keep), [_t(feats)], rt, r,
                               capacity=capacity // 2)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(crt.numpy(), np.asarray(crj))


def test_neus_packed_sdf_to_alpha_matches_jax():
    from nr3d_lib_tpu.graphics.neus import neus_packed_sdf_to_alpha as ja
    from nr3d_lib_tpu_torch.graphics.neus import \
        neus_packed_sdf_to_alpha as ta

    rng = np.random.default_rng(9)
    sdf = rng.normal(scale=0.05, size=40).astype(np.float32)
    ridx = np.sort(rng.integers(0, 6, 40)).astype(np.int32)
    for last in (False, True):
        np.testing.assert_allclose(
            ta(_t(sdf), 64.0, _t(ridx), append_cdf_1=last).numpy(),
            np.asarray(ja(jnp.asarray(sdf), 64.0, jnp.asarray(ridx),
                          append_cdf_1=last)), rtol=0, atol=1e-6)


# ------------------------------------------------------ the forest model
def _forest_cfg(mode):
    return dict(
        space_cfg={"resolution": (2, 2, 2), "origin": (-1.0, -1.0, -1.0),
                   "block_size": 1.0},
        field_cfg={"surface_cfg": {
            "lotd_cfg": {"lod_res": [8, 16], "lod_n_feats": 2,
                         "lod_types": ["Dense", "Hash"],
                         "hashmap_size": 2 ** 12, "backend": "brick"},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 2, "W": 16}},
        n_march_steps=32, march_mode=mode, max_segments=4,
        steps_per_segment=8)


@pytest.fixture(scope="module", params=["segments", "fixed"])
def forest(request):
    mode = request.param
    jm = JaxForest(**_forest_cfg(mode))
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
    tm = TorchForest(**_forest_cfg(mode), device="cpu")
    tm.load_state_dict(forest_from_jax_state(flat))
    return mode, jm, tm


def test_forest_state_bridge(forest):
    _, jm, tm = forest
    assert tm.space.n_trees == jm.space.n_trees == 8
    assert tm.field.implicit_surface.encoding.flattened_params.shape == (
        8, jm.field.implicit_surface.encoding.flattened_params[...].shape[1])
    assert set(tm.state_dict()) >= {"space.occupied", "space.origin",
                                    "space.block_idx", "accel.occ.val_grid"}
    assert not any(k.startswith(("accel.space", "field.implicit_surface."
                                 "space")) for k in tm.state_dict())


def test_forest_accel_matches_jax(forest):
    mode, jm, tm = forest
    o, d = _rays(N_RAYS, 11)
    x = np.random.default_rng(12).uniform(-1.1, 1.1, (500, 3)
                                          ).astype(np.float32)
    np.testing.assert_array_equal(tm.accel.query(_t(x)).numpy(),
                                  np.asarray(jm.accel.query(jnp.asarray(x))))
    rj = jm.ray_test(jnp.asarray(o), jnp.asarray(d))
    rt = tm.ray_test(_t(o), _t(d))
    if mode == "segments":
        key = jax.random.key(2)
        outs_j = jm.accel.ray_march_segmented(
            jnp.asarray(o), jnp.asarray(d), rj["near"], rj["far"],
            max_segments=4, steps_per_segment=8, perturb_key=key)
        u = np.array(jax.random.uniform(key, (N_RAYS, 4, 8), jnp.float32))
        outs_t = tm.accel.ray_march_segmented(
            _t(o), _t(d), rt["near"], rt["far"], max_segments=4,
            steps_per_segment=8, draw=lambda shape, lo, hi: _t(u))
    else:
        key = jax.random.key(3)
        outs_j = jm.accel.ray_march(jnp.asarray(o), jnp.asarray(d),
                                    rj["near"], rj["far"], perturb_key=key)
        u = np.array(jax.random.uniform(key, (N_RAYS, 32), jnp.float32))
        outs_t = tm.accel.ray_march(_t(o), _t(d), rt["near"], rt["far"],
                                    u=_t(u))
    mask = np.asarray(outs_j[3])
    np.testing.assert_array_equal(outs_t[3].numpy(), mask)
    np.testing.assert_array_equal(outs_t[2].numpy(), np.asarray(outs_j[2]))
    np.testing.assert_allclose(outs_t[0].numpy()[mask],
                               np.asarray(outs_j[0])[mask], rtol=0,
                               atol=1e-6)
    assert mask.sum() > N_RAYS


def _forest_uniforms(key, mode: str, n_imp: int = 16, rounds: int = 2):
    """The forest query's draws in its key split order
    (fields_forest.py:319-341: the march's, then one per upsample
    round)."""
    key, km = jax.random.split(key)
    shape = (N_RAYS, 4, 8) if mode == "segments" else (N_RAYS, 32)
    us = [jax.random.uniform(km, shape, jnp.float32)]
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


@pytest.mark.parametrize("perturb", [False, True])
def test_forest_render_matches_jax(forest, perturb):
    """Against eager JAX: under `jax.jit` XLA's CPU compiler fuses the
    march's t = t_in + (i + u)·dt (up to 2.4e-7 apart at this seed), which
    moves 34 of the 2,048 marched slots across an occupancy cell's face
    and changes 12 of the 64 rays; eager JAX rounds each operation as the
    port does. Perturbed, the port replays JAX's uniforms (`draw`)."""
    mode, jm, tm = forest
    o, d = _rays(N_RAYS, 13)
    key = jax.random.key(17) if perturb else None
    rj, vbj = jm.ray_query(jm.ray_test(jnp.asarray(o), jnp.asarray(d)),
                           key=key)
    draw = _forest_uniforms(key, mode) if perturb else None
    with torch.no_grad():
        rt, vbt = tm.ray_query(tm.ray_test(_t(o), _t(d)), draw=draw)
    assert set(rt) == set(rj)
    for k in rt:
        assert torch.isfinite(rt[k]).all(), k
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), rtol=0,
                                   atol=1e-4, err_msg=k)
    assert int(vbt["n_compact"]) == int(vbj["n_compact"]) > N_RAYS
    np.testing.assert_array_equal(vbt["ridx"].numpy(),
                                  np.asarray(vbj["ridx"]))
    assert float(rt["mask_volume"].mean()) > 0.1


def test_forest_occupancy_update_matches_jax(forest):
    """The per-block EMA update (`OccGridAccelForest.step` at it = 16)
    from the JAX package's cells and points, each block's queried
    through the world-space SDF; off the interval nothing changes. Runs
    last on its models: it changes their grids."""
    from nr3d_lib_tpu.models.accelerations.occgrid import \
        sample_cells_uniform

    _, jm, tm = forest
    key = jax.random.key(16)
    jm.accel.step(16, key, jm.query_occ_val)
    # the cells and points OccGridEmaBatched.step_update draws
    n = int(np.prod(tm.accel.occ.resolution)) // 4
    draws = [sample_cells_uniform(k, tm.accel.occ.resolution, n,
                                  jnp.float32)
             for k in jax.random.split(key, tm.accel.occ.n_batch)]
    idx = _t(np.stack([np.asarray(a) for a, _ in draws]).astype(np.int64))
    x = _t(np.stack([np.asarray(b) for _, b in draws]))
    before = tm.accel.occ.val_grid.clone()
    with torch.no_grad():
        tm.accel.step(5, torch.Generator().manual_seed(0), tm.query_occ_val)
        assert torch.equal(tm.accel.occ.val_grid, before)
        tm.accel.occ.apply_update(idx, x, tm.accel._wrap_query(
            tm.query_occ_val))
    np.testing.assert_allclose(tm.accel.occ.val_grid.numpy(),
                               np.asarray(jm.accel.occ.val_grid[...]),
                               rtol=1e-5, atol=1e-7)
    assert not torch.equal(tm.accel.occ.val_grid, before)


def test_forest_nerf_density_matches_jax(spaces):
    """`LoTDForestNeRF.forward_density` from bridged weights (the space
    is the caller's, not part of the field's state): σ is 0 outside the
    occupied blocks."""
    from nr3d_lib_tpu.models.fields_forest import LoTDForestNeRF as JaxNeRF
    from nr3d_lib_tpu_torch.bridge import from_jax_state
    from nr3d_lib_tpu_torch.models.fields_forest import \
        LoTDForestNeRF as TorchNeRF

    js, ts = spaces
    cfg = dict(lotd_cfg={"lod_res": [8, 16], "lod_types": ["Dense", "Hash"],
                         "backend": "brick"},
               decoder_cfg={"D": 1, "W": 16}, radiance_cfg={"D": 2, "W": 16})
    jn = JaxNeRF(js, **cfg)
    flat = {"/".join(map(str, k)): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(jn))
            if isinstance(v, nnx.Variable)}
    key = "encoding/flattened_params"
    flat[key] = np.random.default_rng(14).uniform(
        -0.1, 0.1, flat[key].shape).astype(np.float32)
    state = nnx.state(jn)
    for k, v in nnx.to_flat_state(state):
        if isinstance(v, nnx.Variable):
            v[...] = jnp.asarray(flat["/".join(map(str, k))])
    nnx.update(jn, state)
    tn = TorchNeRF(ts, **cfg, device="cpu")
    tn.load_state_dict(from_jax_state(
        {k: v for k, v in flat.items() if not k.startswith("space/")}))
    x = np.random.default_rng(15).uniform(-1.1, 1.1, (2000, 3)
                                          ).astype(np.float32)
    oj = jn.forward_density(jnp.asarray(x))
    with torch.no_grad():
        ot = tn.forward_density(_t(x))
    for k in ("sigma", "h"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    out = ts.block_of_points(_t(x)) < 0
    assert out.any() and not ot["sigma"][out].any()


def test_forest_xla_backend_raises():
    """The classic backend (the JAX default) builds now that the classic
    LoTD is ported (its parity is in test_torch_lotd_fields.py); what
    still raises is the brick backend at lod_n_feats 4."""
    cfg = _forest_cfg("fixed")
    cfg["field_cfg"]["surface_cfg"]["lotd_cfg"] = {"lod_res": [8, 16]}
    enc = TorchForest(**cfg, device="cpu").field.implicit_surface.encoding
    assert enc.backend == "xla"
    assert enc.flattened_params.shape == (8, enc.meta.n_params)
    cfg["field_cfg"]["surface_cfg"]["lotd_cfg"] = {
        "lod_res": [8, 16], "lod_n_feats": 4, "backend": "brick"}
    with pytest.raises(ValueError, match="lod_n_feats 2"):
        TorchForest(**cfg, device="cpu")
