"""Port parity: the F=2 brick encoding (nr3d_lib_tpu_torch.ops.lotd_brick,
the plain versions of kernels B6–B9, and LoTDBrickEncoding with n_feats=2)
against the JAX package on the CPU.

The JAX side is the package's own entry points, which off-TPU take their
XLA formulation: `brick_encode` and `brick_nablas` and `jax.vjp` of them
(nr3d_lib_tpu/ops/lotd_brick.py `_bwd`, `_bwd_frozen`, `_nablas_bwd`). The
Pallas kernels are not run in interpret mode here: at the production block
size they trace for many minutes. The port's side is its CPU route (plain
PyTorch versions and torch autograd) and the plain backwards the CUDA
kernels are held against on the card. Two metas: Dense and Hash levels
with a 64-row hash, and eight levels (the most the F=2 kernels take). The
points include cell boundaries of every level and the cube's faces.

Tolerances: indices and fractions must be equal; the encode sums 8
products in another order (rtol 1e-6: the table is f32, nothing is
quantized); the nablas, the encode's dL/dx and the second-order gradients
multiply by (res−2) or (res−2)² and sum over corners, features and levels
(rtol 1e-5); the table gradients sum up to a few hundred weighted products
per slot in another order (rtol 1e-5). Each has an absolute floor of 1e-6
of the largest value.

The last tests run the two CUDA `autograd.Function`s on CPU tensors with
their kernel calls replaced by the plain versions, to check what they save,
which gradients they ask the kernels for, and what they return.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.ops import lotd_brick as JB
from nr3d_lib_tpu_torch.ops import lotd_brick as TB

torch.set_num_threads(1)

METAS = {
    "dense_hash": ([8, 16, 32], ["Dense", "Dense", "Hash"], 64),
    "eight_levels": ([8, 12, 16, 24, 32, 48, 64, 96],
                     ["Dense"] * 3 + ["Hash"] * 5, 64),
}
N = 2048


@pytest.fixture(params=sorted(METAS))
def metas(request):
    args = METAS[request.param]
    return JB.make_brick_meta(*args), TB.make_brick_meta(*args), args[0]


def _inputs(meta, lod_res, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    for i, r in enumerate(lod_res):             # cell boundaries of each level
        k = rng.integers(0, r - 2, (32, 3))
        x[32 * i:32 * (i + 1)] = ((k + 0.5) / (r - 2)).astype(np.float32)
    x[-8:] = np.asarray([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]] * 2,
                        np.float32)
    table = rng.uniform(-0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)
    L = meta.n_levels
    g = rng.standard_normal((N, 2 * L)).astype(np.float32)
    gg = rng.standard_normal((N, 3)).astype(np.float32)
    return x, table, g, gg


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * float(np.abs(want).max()))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_meta_and_indexing_bit_equal(metas):
    jm, tm, lod_res = metas
    assert [(a.res, a.kind, a.n_rows, a.bricks_per_axis, a.row_offset)
            for a in jm.levels] == \
        [(b.res, b.kind, b.n_rows, b.bricks_per_axis, b.row_offset)
         for b in tm.levels]
    x, *_ = _inputs(jm, lod_res)
    for jl, tl in zip(jm.levels, tm.levels):
        jr, jlane, jfrac = JB._level_rows_and_lanes(jnp.asarray(x), jl)
        tr, tlane, tfrac = TB._level_rows_and_lanes(torch.from_numpy(x), tl)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jlane), tlane.numpy())
        np.testing.assert_array_equal(np.asarray(jfrac), tfrac.numpy())


def test_encode_and_corner_values_match_jax(metas):
    jm, tm, lod_res = metas
    x, t, _, _ = _inputs(jm, lod_res, 1)
    yj = np.asarray(JB.brick_encode(jnp.asarray(x), jnp.asarray(t), jm))
    xt, tt = _t(x, t)
    yt = TB.brick_encode(xt, tt, tm)
    assert yt.shape == (N, 2 * tm.n_levels) and yt.dtype == torch.float32
    _close(yt, yj, 1e-6)
    np.testing.assert_array_equal(
        TB.brick_encode_xla(xt, tt, tm).numpy(), yt.numpy())
    # B6's want_g output: each corner's two features, weights recombine y
    c = TB.brick_corner_values_xla(xt, tt, tm)
    assert c.shape == (N, tm.n_levels, 8, 2)
    w = torch.stack([TB._corner_weights(TB._level_rows_and_lanes(xt, lv)[2])
                     for lv in tm.levels], 1)                    # [N,L,8]
    _close((w[..., None] * c).sum(2).reshape(N, -1), yj, 1e-6)


def test_encode_grads_match_jax(metas):
    jm, tm, lod_res = metas
    x, t, g, _ = _inputs(jm, lod_res, 2)
    _, vjp = jax.vjp(lambda xx, tt: JB.brick_encode(xx, tt, jm),
                     jnp.asarray(x), jnp.asarray(t))
    jdx, jdt = vjp(jnp.asarray(g))
    assert float(np.abs(np.asarray(jdt)).max()) > 0
    xt, tt = (a.requires_grad_(True) for a in _t(x, t))
    dx, dt = torch.autograd.grad(TB.brick_encode(xt, tt, tm), (xt, tt),
                                 torch.from_numpy(g))
    _close(dx, jdx, 1e-5)
    _close(dt, jdt, 1e-5)
    # the plain backward B7 is held against, both forms
    pdx, pdt = TB.brick_encode_bwd_xla(*_t(x, t, g), tm, True)
    _close(pdx, jdx, 1e-5)
    _close(pdt, jdt, 1e-5)
    ndx, ndt = TB.brick_encode_bwd_xla(*_t(x, t, g), tm, False)
    assert ndx is None
    _close(ndt, jdt, 1e-5)
    # the frozen-x encode: the table's gradient only, x a constant
    _, vjpf = jax.vjp(lambda xx, tt: JB.brick_encode_frozen_x(xx, tt, jm),
                      jnp.asarray(x), jnp.asarray(t))
    fdx, fdt = vjpf(jnp.asarray(g))
    assert not np.asarray(fdx).any()
    xt, tt = (a.requires_grad_(True) for a in _t(x, t))
    y = TB.brick_encode_frozen_x(xt, tt, tm)
    assert y.grad_fn is not None
    (dt,) = torch.autograd.grad(y, (tt,), torch.from_numpy(g))
    _close(dt, fdt, 1e-5)
    with pytest.raises(RuntimeError):           # x carries no gradient
        torch.autograd.grad(TB.brick_encode_frozen_x(xt, tt, tm).sum(), xt)


def test_nablas_and_second_order_match_jax(metas):
    jm, tm, lod_res = metas
    x, t, g, gg = _inputs(jm, lod_res, 3)
    nj, vjp = jax.vjp(lambda gu, xx, tt: JB.brick_nablas(gu, xx, tt, jm),
                      jnp.asarray(g), jnp.asarray(x), jnp.asarray(t))
    jdg, jdx, jdt = vjp(jnp.asarray(gg))
    gt, xt, tt = (a.requires_grad_(True) for a in _t(g, x, t))
    nt = TB.brick_nablas(gt, xt, tt, tm)
    _close(nt, nj, 1e-5)
    # the analytic plain version equals autograd through the plain encode
    (ga,) = torch.autograd.grad(TB.brick_encode_xla(xt, tt, tm), xt,
                                torch.from_numpy(g))
    _close(nt, ga.numpy(), 1e-5)
    grads = torch.autograd.grad(nt, (gt, xt, tt), torch.from_numpy(gg))
    plain = TB.brick_nablas_bwd_xla(*_t(g, x, t, gg), tm)
    for got in (grads, plain):
        for a, b in zip(got, (jdg, jdx, jdt)):
            _close(a, b, 1e-5)
    # the cross terms (res_a−2)(res_b−2)·∂²w/∂x_a∂x_b are not vacuous
    assert float(np.abs(np.asarray(jdx)).max()) > 1.0


def test_dense_materialization_ties_boundary_vertices():
    meta_args = METAS["dense_hash"]
    jm, tm = JB.make_brick_meta(*meta_args), TB.make_brick_meta(*meta_args)
    for jl, tl in zip(jm.levels, tm.levels):
        if jl.kind != "dense":
            continue
        np.testing.assert_array_equal(JB.vertex_grid_to_brick_rows(jl),
                                      TB.vertex_grid_to_brick_rows(tl))
        n = int(np.prod(jl.res)) * 2
        p = np.random.default_rng(4).standard_normal(n).astype(np.float32)
        gr = np.random.default_rng(5).standard_normal(
            (jl.n_rows, 128)).astype(np.float32)
        rows_j, vjp = jax.vjp(lambda v: JB.materialize_dense_brick_table(
            v, jl), jnp.asarray(p))
        (gj,) = vjp(jnp.asarray(gr))
        pt = torch.from_numpy(p).requires_grad_(True)
        rows_t = TB.materialize_dense_brick_table(pt, tl)
        np.testing.assert_array_equal(rows_t.detach().numpy(),
                                      np.asarray(rows_j))
        (gt,) = torch.autograd.grad(rows_t, pt, torch.from_numpy(gr))
        _close(gt, gj, 1e-6)
        # a vertex on a brick face appears in two bricks and gets both
        # slots' gradients; an interior one gets one slot's
        idx = TB.vertex_grid_to_brick_rows(tl).reshape(-1)
        counts = np.bincount(idx, minlength=n)
        shared = int(np.argmax(counts))
        assert counts[shared] >= 2
        assert float(gt[shared]) == pytest.approx(
            float(gr.reshape(-1)[idx == shared].sum()), rel=1e-5)


def test_encoding_module_matches_jax():
    """LoTDBrickEncoding with n_feats=2 (the default) through the JAX and
    port factories: values, nablas and both differentiated into
    `flattened_params`, the dense levels' tied vertices included."""
    from nr3d_lib_tpu.models.grid_encodings.lotd import \
        get_lotd_encoding as jget
    from nr3d_lib_tpu_torch.models.grid_encodings.lotd import \
        get_lotd_encoding as tget

    lod_res, types, rows = METAS["dense_hash"]
    cfg = dict(backend="brick", hashmap_rows=rows,
               lotd_cfg={"lod_res": lod_res, "lod_types": types,
                         "hashmap_size": 2 ** 16})
    je = jget(3, **cfg)
    te = tget(3, **cfg, device="cpu", frozen_x=True)   # extra keys ignored
    assert te.n_feats == 2 and te.n_params == je.n_params
    assert te.out_features == je.out_features == 6
    rng = np.random.default_rng(6)
    p = rng.uniform(-0.1, 0.1, je.n_params).astype(np.float32)
    je.flattened_params[...] = jnp.asarray(p)
    with torch.no_grad():
        te.flattened_params.copy_(torch.from_numpy(p))
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    g, gu = (rng.standard_normal((N, 6)).astype(np.float32) for _ in "ab")
    gg = rng.standard_normal((N, 3)).astype(np.float32)

    graphdef, params = nnx.split(je, nnx.Param)

    def jloss(pp):
        m = nnx.merge(graphdef, pp)
        y = m(jnp.asarray(x))
        nab = m.nablas_path(jnp.asarray(x), jnp.asarray(gu))
        return jnp.sum(y * jnp.asarray(g)) + jnp.sum(nab * jnp.asarray(gg))

    jgrad = jax.grad(jloss)(params)["flattened_params"][...]
    xt = torch.from_numpy(x)
    yt = te(xt)
    _close(yt, je(jnp.asarray(x)), 1e-6)
    nt = te.nablas_path(xt, torch.from_numpy(gu))
    _close(nt, je.nablas_path(jnp.asarray(x), jnp.asarray(gu)), 1e-5)
    loss = (yt * torch.from_numpy(g)).sum() + \
        (nt * torch.from_numpy(gg)).sum()
    (tgrad,) = torch.autograd.grad(loss, te.flattened_params)
    _close(tgrad, jgrad, 1e-5)
    n_dense = (8 ** 3 + 16 ** 3) * 2
    assert np.count_nonzero(np.asarray(jgrad)[:n_dense]) > 0.3 * n_dense
    # frozen_x: same values, no gradient to x
    xr = xt.clone().requires_grad_(True)
    yf = te(xr, frozen_x=True)
    np.testing.assert_array_equal(yf.detach().numpy(), yt.detach().numpy())
    assert torch.autograd.grad(yf.sum(), xr, allow_unused=True)[0] is None
    # ho: the any-order plain encode, JAX's `brick_encode_ho` (on the CPU
    # the same plain version as the default route, so the same bits)
    yh = te(xt, ho=True)
    np.testing.assert_array_equal(yh.detach().numpy(), yt.detach().numpy())
    _close(yh, je(jnp.asarray(x), ho=True), 1e-6)
    with pytest.raises(ValueError, match="n_feats"):
        tget(3, **{**cfg, "lotd_cfg": {**cfg["lotd_cfg"], "lod_n_feats": 3}},
             device="cpu")


def test_wrappers_route_by_device():
    tm = TB.make_brick_meta(*METAS["dense_hash"])
    x = torch.zeros(4, 3, device="meta")
    t = torch.zeros(tm.total_rows, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TB.brick_encode(x, t, tm)
    with pytest.raises(ValueError, match="unsupported device"):
        TB.brick_encode_frozen_x(x, t, tm)
    with pytest.raises(ValueError, match="unsupported device"):
        TB.brick_nablas(torch.zeros(4, 6, device="meta"), x, t, tm)
    with pytest.raises(ValueError, match="at most 8 levels"):
        TB.c_meta(TB.make_brick_meta([8] * 9, ["Dense"] * 9))
    assert TB.c_meta(TB.make_brick_meta(*METAS["eight_levels"])).n_levels == 8
    with pytest.raises(ValueError, match=r"table must be \[216, 128\]"):
        TB.check_cuda_args(torch.zeros(4, 3), torch.zeros(216, 256), tm,
                           128, "brick_encode")


def _swap_kernels(monkeypatch, table, calls):
    def fwd(x_, t_, meta, want_g=False):
        calls.append(("fwd", want_g))
        y = TB.brick_encode_xla(x_, t_, meta)
        return (y, TB.brick_corner_values_xla(x_, t_, meta)) if want_g else y

    def bwd(x_, g_, meta, *, need_dx, corners=None, table=None):
        calls.append(("bwd", need_dx, corners is not None))
        return TB.brick_encode_bwd_xla(x_, table_, g_, meta, need_dx)

    def dydx(g_, x_, t_, meta):
        calls.append(("dydx",))
        return TB.brick_nablas_xla(g_, x_, t_, meta)

    def bwd2(g_, x_, t_, gg_, meta, need_dx=True):
        calls.append(("bwd2", need_dx))
        dg, dx, dt = TB.brick_nablas_bwd_xla(g_, x_, t_, gg_, meta)
        return dg, (dx if need_dx else None), dt

    table_ = table
    monkeypatch.setattr(TB, "_fwd_cuda", fwd)
    monkeypatch.setattr(TB, "_bwd_cuda", bwd)
    monkeypatch.setattr(TB, "_dydx_cuda", dydx)
    monkeypatch.setattr(TB, "_bwd2_cuda", bwd2)


def test_cuda_functions_plumbing(monkeypatch):
    """`_BrickEncode` / `_BrickNablas` with their kernel calls swapped for
    the plain versions, against torch autograd through the plain forward."""
    tm = TB.make_brick_meta(*METAS["dense_hash"])
    x, t, g, gg = _inputs(tm, METAS["dense_hash"][0], 7)
    table = torch.from_numpy(t)
    calls = []
    _swap_kernels(monkeypatch, table, calls)
    gu = np.random.default_rng(8).standard_normal((N, 6)).astype(np.float32)
    for x_grad in (True, False):
        routes = ((lambda xx, tt: TB._BrickEncode.apply(xx, tt, tm, x_grad),
                   TB._BrickNablas.apply),
                  (lambda xx, tt: TB.brick_encode_xla(xx, tt, tm),
                   TB.brick_nablas_xla))
        calls.clear()
        grads = []
        for encode, nablas in routes:
            xs = torch.from_numpy(x).requires_grad_(x_grad)
            ts = table.clone().requires_grad_(True)
            gs = torch.from_numpy(gu).requires_grad_(True)
            loss = (encode(xs, ts) * torch.from_numpy(g)).sum() + \
                (nablas(gs, xs, ts, tm) * torch.from_numpy(gg)).sum()
            grads.append(torch.autograd.grad(
                loss, [xs, ts, gs] if x_grad else [ts, gs]))
        got, want = grads
        for a, b in zip(got, want):
            _close(a, b.numpy(), 1e-5)
        assert calls == [("fwd", x_grad), ("dydx",), ("bwd2", x_grad),
                         ("bwd", x_grad, x_grad)], calls
    with pytest.raises(RuntimeError):       # not differentiable twice
        gt = torch.from_numpy(g).requires_grad_(True)
        nab = TB._BrickNablas.apply(gt, torch.from_numpy(x),
                                    table.clone().requires_grad_(True), tm)
        (dg,) = torch.autograd.grad(nab.sum(), gt, create_graph=True)
        torch.autograd.grad(dg.sum(), gt)


def test_meta_with_no_level_is_refused_like_jax():
    """A brick meta with no level: the JAX reference refuses it (nothing
    to stack), and so do the port's plain version, its entry on a CPU
    tensor and the kernels' `c_meta`, F=2 and F=4 alike; the C entries'
    own guards at such a meta are held on the card
    (`test_torch_kernels_gpu.py::test_backward_entries_at_zero_levels`)."""
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as TB4

    x = np.random.default_rng(0).uniform(size=(5, 3)).astype(np.float32)
    jmeta = JB.make_brick_meta([], [], 64)
    with pytest.raises(ValueError):
        JB.brick_encode_xla(jnp.asarray(x), jnp.zeros((0, 128), jnp.float32),
                            jmeta)
    meta = TB.make_brick_meta([], [], 64)
    assert meta.n_levels == 0 and meta.total_rows == 0
    xt, tab = torch.from_numpy(x), torch.zeros((0, 128))
    for call in (lambda: TB.brick_encode_xla(xt, tab, meta),
                 lambda: TB.brick_encode(xt, tab, meta),
                 lambda: TB.brick_nablas(torch.zeros((5, 0)), xt, tab, meta)):
        with pytest.raises((ValueError, RuntimeError, TypeError)):
            call()
    for m, struct in ((meta, TB._Meta),
                      (TB4.make_brick4_meta([], [], 64), TB4._Meta)):
        with pytest.raises(ValueError, match="at least one level"):
            TB.c_meta(m, struct)
    assert TB.c_meta(TB.make_brick_meta([16], ["Dense"], 64)).n_levels == 1
