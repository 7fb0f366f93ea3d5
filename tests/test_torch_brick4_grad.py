"""Port parity: the gradients of the F=4 brick encoding (B2, the encode's
backward, and B4, the nablas' backward) against the JAX package on the CPU.

The JAX side is `jax.vjp` of `brick4_encode` / `brick4_nablas`, whose
custom_vjp takes its XLA route off-TPU (nr3d_lib_tpu/ops/lotd_brick4.py
`_bwd4` and `_nablas4_bwd`). The port's side is its CPU route (the plain
PyTorch versions and torch autograd) and the plain backwards
`brick4_encode_bwd_xla` / `brick4_nablas_bwd_xla`, which the CUDA kernels
are held against on the card. The points include cell boundaries of both
levels and the cube's faces; through `LoTDBrickEncoding` the dense level's
tied boundary vertices accumulate into `flattened_params`.

Tolerances: the encode's gradients sum a few weighted products per slot in
another order (rtol 1e-5); the nablas' and second-order gradients multiply
by (res−2)² and sum over corners, features and levels (rtol 1e-4), each
with an absolute floor of 1e-6 of the largest value.

The last test runs the two CUDA `autograd.Function`s on CPU tensors with
their kernel calls replaced by the plain versions, to check what they save,
which gradients they ask the kernels for, and what they return.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.ops import lotd_brick4 as JB4
from nr3d_lib_tpu_torch.ops import lotd_brick4 as TB4

torch.set_num_threads(1)

LOD_RES = [16, 64]
LOD_TYPES = ["Dense", "Hash"]
HASHMAP_ROWS = 64
N = 2048


def _metas():
    return (JB4.make_brick4_meta(LOD_RES, LOD_TYPES, HASHMAP_ROWS),
            TB4.make_brick4_meta(LOD_RES, LOD_TYPES, HASHMAP_ROWS))


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    for i, r in enumerate(LOD_RES):            # cell boundaries of each level
        k = rng.integers(0, r - 2, (64, 3))
        x[64 * i:64 * (i + 1)] = ((k + 0.5) / (r - 2)).astype(np.float32)
    x[128:136] = np.asarray([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]] * 2,
                            np.float32)
    jm, _ = _metas()
    table = rng.uniform(-0.1, 0.1, (jm.total_rows, 256)).astype(np.float32)
    g = rng.standard_normal((N, 8)).astype(np.float32)
    gg = rng.standard_normal((N, 3)).astype(np.float32)
    return x, table, g, gg


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * float(np.abs(want).max()))


def test_encode_grads_match_jax():
    jm, tm = _metas()
    x, t, g, _ = _inputs()
    _, vjp = jax.vjp(lambda xx, tt: JB4.brick4_encode(xx, tt, jm),
                     jnp.asarray(x), jnp.asarray(t))
    jdx, jdt = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    y = TB4.brick4_encode(xt, tt, tm)
    dx, dt = torch.autograd.grad(y, (xt, tt), torch.from_numpy(g))
    _close(dx, jdx, 1e-4)          # dL/dx carries the (res−2) scale
    _close(dt, jdt, 1e-5)
    assert float(np.abs(np.asarray(jdt)).max()) > 0
    # the plain backward the B2 kernel is held against, both forms
    pdx, pdt = TB4.brick4_encode_bwd_xla(torch.from_numpy(x),
                                         torch.from_numpy(t),
                                         torch.from_numpy(g), tm, True)
    _close(pdx, jdx, 1e-4)
    _close(pdt, jdt, 1e-5)
    ndx, ndt = TB4.brick4_encode_bwd_xla(torch.from_numpy(x),
                                         torch.from_numpy(t),
                                         torch.from_numpy(g), tm, False)
    assert ndx is None
    _close(ndt, jdt, 1e-5)


def test_nablas_grads_match_jax():
    jm, tm = _metas()
    x, t, g, gg = _inputs(1)
    _, vjp = jax.vjp(lambda gu, xx, tt: JB4.brick4_nablas(gu, xx, tt, jm),
                     jnp.asarray(g), jnp.asarray(x), jnp.asarray(t))
    jdg, jdx, jdt = vjp(jnp.asarray(gg))
    gt = torch.from_numpy(g).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    nab = TB4.brick4_nablas(gt, xt, tt, tm)
    grads = torch.autograd.grad(nab, (gt, xt, tt), torch.from_numpy(gg))
    plain = TB4.brick4_nablas_bwd_xla(torch.from_numpy(g), torch.from_numpy(x),
                                      torch.from_numpy(t),
                                      torch.from_numpy(gg), tm)
    for got in (grads, plain):
        for a, b in zip(got, (jdg, jdx, jdt)):
            _close(a, b, 1e-4)
    # the cross terms (res_a−2)(res_b−2)·∂²w/∂x_a∂x_b are not vacuous
    assert float(np.abs(np.asarray(jdx)).max()) > 1.0


def test_encoding_module_param_grads_match_jax():
    """Through LoTDBrickEncoding: the encode and the nablas path both
    differentiated into `flattened_params` (the dense level's tied vertices
    accumulate through the index backward of `_build_table`)."""
    from nr3d_lib_tpu.models.grid_encodings.lotd import \
        get_lotd_encoding as jget
    from nr3d_lib_tpu_torch.models.grid_encodings.lotd import \
        get_lotd_encoding as tget

    cfg = dict(backend="brick", hashmap_rows=HASHMAP_ROWS,
               lotd_cfg={"lod_res": LOD_RES, "lod_n_feats": 4,
                         "lod_types": LOD_TYPES, "hashmap_size": 2 ** 16})
    je = jget(3, **cfg)
    te = tget(3, **cfg, device="cpu")
    rng = np.random.default_rng(2)
    p = rng.uniform(-0.1, 0.1, je.n_params).astype(np.float32)
    je.flattened_params[...] = jnp.asarray(p)
    with torch.no_grad():
        te.flattened_params.copy_(torch.from_numpy(p))
    x01, _, g, gg = _inputs(3)
    x = x01 * 2.0 - 1.0                       # module convention [-1,1]
    gu = rng.standard_normal((N, 8)).astype(np.float32)

    graphdef, params = nnx.split(je, nnx.Param)

    def jloss(pp):
        m = nnx.merge(graphdef, pp)
        y = m(jnp.asarray(x))
        nab = m.nablas_path(jnp.asarray(x), jnp.asarray(gu))
        return jnp.sum(y * jnp.asarray(g)) + jnp.sum(nab * jnp.asarray(gg))

    jgrad = jax.grad(jloss)(params)["flattened_params"][...]
    xt = torch.from_numpy(x)
    loss = (te(xt) * torch.from_numpy(g)).sum() + \
        (te.nablas_path(xt, torch.from_numpy(gu)) * torch.from_numpy(gg)).sum()
    (tgrad,) = torch.autograd.grad(loss, te.flattened_params)
    _close(tgrad, jgrad, 1e-4)
    # the dense level's params are reached, boundary vertices included
    n_dense = int(np.prod(LOD_RES[0] * np.ones(3, int))) * 4
    assert np.count_nonzero(np.asarray(jgrad)[:n_dense]) > 0.5 * n_dense


def test_cuda_functions_plumbing(monkeypatch):
    """`_Brick4Encode` / `_Brick4Nablas` with their kernel calls swapped for
    the plain versions: what they save and ask for, and what they return,
    against torch autograd through the plain forward."""
    _, tm = _metas()
    x, t, g, gg = _inputs(4)
    table = torch.from_numpy(t)
    calls = []

    def fwd(x_, packed, meta, want_g=False):
        calls.append(("fwd", want_g))
        y = TB4.brick4_encode_xla(x_, table, meta)
        return (y, torch.zeros(x_.shape[0], meta.n_levels, 8, 2,
                               dtype=torch.int32)) if want_g else y

    def bwd(x_, g_, meta, *, need_dx, words=None, packed=None):
        calls.append(("bwd", need_dx, words is not None))
        return TB4.brick4_encode_bwd_xla(x_, table, g_, meta, need_dx)

    def dydx(g_, x_, packed, meta):
        calls.append(("dydx",))
        return TB4.brick4_nablas_xla(g_, x_, table, meta)

    def bwd2(g_, x_, packed, gg_, meta, need_dx=True):
        calls.append(("bwd2", need_dx))
        dg, dx, dt = TB4.brick4_nablas_bwd_xla(g_, x_, table, gg_, meta)
        return dg, (dx if need_dx else None), dt

    monkeypatch.setattr(TB4, "_fwd_cuda", fwd)
    monkeypatch.setattr(TB4, "_bwd_cuda", bwd)
    monkeypatch.setattr(TB4, "_dydx_cuda", dydx)
    monkeypatch.setattr(TB4, "_bwd2_cuda", bwd2)

    gu = np.random.default_rng(5).standard_normal((N, 8)).astype(np.float32)
    for x_grad in (True, False):
        routes = ((lambda xx, tt: TB4._Brick4Encode.apply(xx, tt, tm, x_grad),
                   TB4._Brick4Nablas.apply),
                  (lambda xx, tt: TB4.brick4_encode_xla(xx, tt, tm),
                   TB4.brick4_nablas_xla))
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
        nab = TB4._Brick4Nablas.apply(gt, torch.from_numpy(x),
                                      table.clone().requires_grad_(True), tm)
        (dg,) = torch.autograd.grad(nab.sum(), gt, create_graph=True)
        torch.autograd.grad(dg.sum(), gt)
