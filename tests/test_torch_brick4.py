"""Port parity: F=4 brick encoding (nr3d_lib_tpu_torch.ops.lotd_brick4 and
LoTDBrickEncoding) against the JAX package on the CPU.

The same numpy-seeded float32 inputs go through the JAX function (its XLA
formulation, which is what the JAX package runs off-TPU) and the port's
CPU route (the plain PyTorch version of kernels B1 and B3).
Tolerances: indices and packed bits must be equal; the encode sums 8
products in another order (rtol 1e-5); the nablas multiply by res-2 and
sum over corners and levels (rtol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nr3d_lib_tpu.ops import lotd_brick as JB
from nr3d_lib_tpu.ops import lotd_brick4 as JB4
from nr3d_lib_tpu_torch.ops import lotd_brick as TB
from nr3d_lib_tpu_torch.ops import lotd_brick4 as TB4

torch.set_num_threads(1)

LOD_RES = [16, 64]
LOD_TYPES = ["Dense", "Hash"]
HASHMAP_ROWS = 64
# the nablas' metas: the render's, and the F=4 NeRF's three levels
# (experiments/bench_render.py:37-43)
NABLAS_METAS = {"2_levels": (LOD_RES, LOD_TYPES),
                "3_levels": ([16, 64, 512], ["Dense", "Hash", "Hash"])}


def _metas(lod_res=LOD_RES, lod_types=LOD_TYPES):
    return (JB4.make_brick4_meta(lod_res, lod_types, HASHMAP_ROWS),
            TB4.make_brick4_meta(lod_res, lod_types, HASHMAP_ROWS))


def _points(n: int, seed: int = 0, lod_res=LOD_RES) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    # points exactly on cell boundaries of every level, and the cube's faces
    for i, r in enumerate(lod_res):
        k = rng.integers(0, r - 2, (64, 3))
        x[64 * i:64 * (i + 1)] = ((k + 0.5) / (r - 2)).astype(np.float32)
    m = 64 * len(lod_res)
    x[m:m + 8] = np.asarray([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]] * 2,
                            np.float32)
    return x


def _table(meta, seed: int = 1, scale: float = 0.1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, (meta.total_rows, 256)).astype(np.float32)


def test_meta_matches():
    jm, tm = _metas()
    assert len(jm.levels) == len(tm.levels)
    for a, b in zip(jm.levels, tm.levels):
        assert (a.res, a.kind, a.n_rows, a.bricks_per_axis, a.row_offset) == \
            (b.res, b.kind, b.n_rows, b.bricks_per_axis, b.row_offset)
    assert jm.total_rows == tm.total_rows


def test_rows_lanes_bit_equal():
    jm, tm = _metas()
    x = _points(4096)
    for jl, tl in zip(jm.levels, tm.levels):
        jr, jlane, jfrac = JB._level_rows_and_lanes(jnp.asarray(x), jl)
        tr, tlane, tfrac = TB._level_rows_and_lanes(torch.from_numpy(x), tl)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jlane), tlane.numpy())
        np.testing.assert_array_equal(np.asarray(jfrac), tfrac.numpy())


def test_vertex_grid_and_dense_materialization():
    jm, tm = _metas()
    dense = jm.levels[0]
    np.testing.assert_array_equal(JB.vertex_grid_to_brick_rows(dense),
                                  TB.vertex_grid_to_brick_rows(tm.levels[0]))
    p = np.random.default_rng(2).standard_normal(
        int(np.prod(dense.res)) * 4).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(JB4.materialize_dense_brick4(jnp.asarray(p), dense)),
        TB4.materialize_dense_brick4(torch.from_numpy(p), tm.levels[0]).numpy())


def test_pack_table4_bit_equal():
    jm, _ = _metas()
    t = _table(jm)
    # ties and specials: exact bf16 halfway points (RNE), ±0, tiny values
    t[0, :8] = np.asarray([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -0.0, 0.0,
                           1e-40, -1e-40, 3.0e38, -2.5], np.float32)
    jp = np.asarray(JB4.pack_table4(jnp.asarray(t))).view(np.uint32)
    tp = TB4.pack_table4(torch.from_numpy(t)).numpy().view(np.uint32)
    np.testing.assert_array_equal(jp, tp)


def test_encode_matches_jax():
    jm, tm = _metas()
    x, t = _points(4096), _table(jm)
    yj = np.asarray(JB4.brick4_encode(jnp.asarray(x), jnp.asarray(t), jm))
    yt = TB4.brick4_encode(torch.from_numpy(x), torch.from_numpy(t), tm)
    assert yt.shape == (4096, 8) and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("levels", sorted(NABLAS_METAS))
def test_nablas_matches_jax_and_autograd(levels):
    lod_res, lod_types = NABLAS_METAS[levels]
    jm, tm = _metas(lod_res, lod_types)
    x, t = _points(2048, lod_res=lod_res), _table(jm)
    g = np.random.default_rng(3).standard_normal(
        (2048, 4 * len(lod_res))).astype(np.float32)
    nj = np.asarray(JB4.brick4_nablas(jnp.asarray(g), jnp.asarray(x),
                                      jnp.asarray(t), jm))
    nt = TB4.brick4_nablas(torch.from_numpy(g), torch.from_numpy(x),
                           torch.from_numpy(t), tm)
    np.testing.assert_allclose(nt.numpy(), nj, rtol=1e-4, atol=1e-5)
    # the analytic plain version equals autograd through the plain encode
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TB4.brick4_encode_xla(xt, torch.from_numpy(t), tm)
    (ga,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(nt.numpy(), ga.numpy(), rtol=1e-4, atol=1e-5)


def test_encoding_module_matches_jax():
    from nr3d_lib_tpu.models.grid_encodings.lotd import \
        get_lotd_encoding as jget
    from nr3d_lib_tpu_torch.models.grid_encodings.lotd import \
        get_lotd_encoding as tget

    cfg = dict(backend="brick", hashmap_rows=HASHMAP_ROWS,
               lotd_cfg={"lod_res": LOD_RES, "lod_n_feats": 4,
                         "lod_types": LOD_TYPES, "hashmap_size": 2 ** 16})
    je = jget(3, **cfg)
    te = tget(3, **cfg, device="cpu")
    assert te.n_params == je.n_params and te.out_features == je.out_features
    p = np.random.default_rng(4).uniform(-0.1, 0.1, je.n_params) \
        .astype(np.float32)
    je.flattened_params[...] = jnp.asarray(p)
    with torch.no_grad():
        te.flattened_params.copy_(torch.from_numpy(p))
    x = np.random.default_rng(5).uniform(-1, 1, (1024, 3)).astype(np.float32)
    g = np.random.default_rng(6).standard_normal((1024, 8)).astype(np.float32)
    with torch.no_grad():
        yt = te(torch.from_numpy(x))
        nt = te.nablas_path(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(yt.numpy(), np.asarray(je(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        nt.numpy(), np.asarray(je.nablas_path(jnp.asarray(x), jnp.asarray(g))),
        rtol=1e-4, atol=1e-5)


def test_wrappers_route_by_device():
    _, tm = _metas()
    x = torch.zeros(4, 3, device="meta")
    t = torch.zeros(tm.total_rows, 256, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TB4.brick4_encode(x, t, tm)
    with pytest.raises(ValueError, match="unsupported device"):
        TB4.brick4_nablas(torch.zeros(4, 8, device="meta"), x, t, tm)
    with pytest.raises(ValueError, match="max 4 levels"):
        TB4.make_brick4_meta([8] * 5, ["Dense"] * 5)
