"""Port parity: the classic LoTD encoding (`ops/lotd.py`) against the JAX
package's on the CPU.

The same numpy-seeded float32 inputs (the conftest turns on x64, so the
JAX side is handed float32 arrays) go through `nr3d_lib_tpu.ops.lotd`
and `nr3d_lib_tpu_torch.ops.lotd`, both eager:

* every LoD type in 3D (Dense, Hash, CP, CPfast, NPlaneSum, NPlaneMul,
  VectorMatrix, VecZMatXoY), and Dense, Hash, CP and NPlaneSum in 2D and
  4D, at cuboid resolutions, with linear and smoothstep interpolation:
  the forward, dL/dparams and dL/dx of a weighted sum, and the second
  order (the gradient of nablas·w with respect to params and x, against
  `jax.grad` of `jax.grad`);
* the hash: indices equal as integers, negative cells included, and a
  Hash level at and one entry past its switch to dense indexing;
* out-of-domain x on the flat clip, batched with a clip that crosses
  into the next instance's rows; bidx −1; max_level as an int and as a
  tensor; level_weights; `lotd_fwd_dydx` and `lotd_bwd_dydx`.

Tolerances: the port keeps JAX's loops and sum order, so the forward is
held within 1e-6 of the output's largest entry (measured: bitwise on
these inputs). Gradients sum the corners' scatters in another order:
dL/dparams within 1e-6 and dL/dx within 1e-5 of their largest entry
(dL/dx carries the resolution). The second order carries the resolution
twice: each within 1e-5 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nr3d_lib_tpu.ops import lotd as J
from nr3d_lib_tpu_torch.ops import lotd as T

torch.set_num_threads(1)

N = 96
RES = {2: [[5, 7], [11, 9]], 3: [[5, 7, 6], [11, 9, 13]],
       4: [[4, 5, 6, 3], [7, 5, 9, 8]]}
CASES = [(3, t) for t in ("Dense", "Hash", "CP", "CPfast", "NPlaneSum",
                          "NPlaneMul", "VM", "VecZMatXoY")] + \
    [(d, t) for d in (2, 4) for t in ("Dense", "Hash", "CP", "NPlaneSum")]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-12), err


def _metas(d, lod_type, smooth=False, hashmap=48):
    kw = dict(hashmap_size=hashmap, use_smooth_step=smooth)
    return (J.generate_meta(d, RES[d], 2, lod_type, **kw),
            T.generate_meta(d, RES[d], 2, lod_type, **kw))


def _inputs(d, n_params, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (N, d)).astype(np.float32),
            rng.uniform(-1.0, 1.0, n_params).astype(np.float32),
            rng.normal(size=(N, 4)).astype(np.float32))


def test_meta_matches_jax():
    for d, ty in CASES:
        mj, mt = _metas(d, ty)
        assert mt.level_sizes == mj.level_sizes
        assert mt.level_offsets == mj.level_offsets
        assert mt.out_features == mj.out_features
        assert [int(t) for t in mt.level_types] == \
            [int(t) for t in mj.level_types]
    assert T.level_param_slice(mt, 1) == J.level_param_slice(mj, 1)
    assert T.HASH_PRIMES == J.HASH_PRIMES


@pytest.mark.parametrize("d,lod_type", CASES,
                         ids=[f"{d}d-{t}" for d, t in CASES])
def test_encode_and_grads_match_jax(d, lod_type):
    smooth = lod_type in ("Dense", "NPlaneSum")
    mj, mt = _metas(d, lod_type, smooth)
    x, p, w = _inputs(d, mj.n_params, 1)
    w = w[:, :1].repeat(mj.out_features, 1)
    yj = J.lotd_encode(jnp.asarray(x), jnp.asarray(p), mj)
    xt, pt = _t(x).requires_grad_(True), _t(p).requires_grad_(True)
    yt = T.lotd_encode(xt, pt, mt)
    _close(yt.detach().numpy(), yj, 1e-6)
    gpj, gxj = jax.grad(lambda pp, xx: jnp.sum(
        J.lotd_encode(xx, pp, mj) * w), (0, 1))(jnp.asarray(p),
                                                jnp.asarray(x))
    gpt, gxt = torch.autograd.grad((yt * _t(w)).sum(), (pt, xt))
    _close(gpt.numpy(), gpj, 1e-6)
    _close(gxt.numpy(), gxj, 1e-5)
    assert float(np.abs(np.asarray(gxj)).max()) > 0


SECOND = [c for c in CASES if c[0] == 3] + [(2, "Hash")]


@pytest.mark.parametrize("d,lod_type", SECOND,
                         ids=[f"{d}d-{t}" for d, t in SECOND])
def test_second_order_matches_jax(d, lod_type):
    """The gradient of Σ nablas·v, nablas = ∂(Σ y·w)/∂x, with respect to
    the params and x: the eikonal loss's path."""
    mj, mt = _metas(d, lod_type, smooth=lod_type == "Dense")
    x, p, w = _inputs(d, mj.n_params, 2)
    w = w[:, :1].repeat(mj.out_features, 1)
    v = np.random.default_rng(3).normal(size=(N, d)).astype(np.float32)

    def jloss(pp, xx):
        nab = jax.grad(lambda x2: jnp.sum(J.lotd_encode(x2, pp, mj) * w))(xx)
        return jnp.sum(nab * v)

    gpj, gxj = jax.grad(jloss, (0, 1))(jnp.asarray(p), jnp.asarray(x))
    xt, pt = _t(x).requires_grad_(True), _t(p).requires_grad_(True)
    (nab,) = torch.autograd.grad((T.lotd_encode(xt, pt, mt) * _t(w)).sum(),
                                 xt, create_graph=True)
    gpt, gxt = torch.autograd.grad((nab * _t(v)).sum(), (pt, xt),
                                   allow_unused=True)
    _close(gpt.numpy(), gpj, 1e-5)
    _close(gxt.numpy(), gxj, 1e-5)
    assert float(np.abs(np.asarray(gpj)).max()) > 0
    assert float(np.abs(np.asarray(gxj)).max()) > 0


def test_hash_index_is_jax_uint32():
    """The hash's indices as integers: negative cells wrap as uint32, the
    primes multiply mod 2^32, at 2 to 7 dimensions."""
    rng = np.random.default_rng(4)
    for d in range(2, 8):
        cell = rng.integers(-2 ** 31, 2 ** 31, (500, d)).astype(np.int32)
        cell[:20] = rng.integers(-3, 3, (20, d))
        for size in (48, 2 ** 16, 2 ** 19 + 7):
            want = np.asarray(J._hash_index(jnp.asarray(cell), size))
            got = T._hash_index(_t(cell).to(torch.int64), size).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("excess", [0, 1])
def test_hash_level_at_and_past_its_dense_switch(excess):
    """A Hash level whose grid holds prod(res) entries: a hashmap of that
    size indexes densely, one entry smaller hashes."""
    res = [[5, 7, 6]]
    size = 5 * 7 * 6 - excess
    mj = J.generate_meta(3, res, 2, "Hash", hashmap_size=size)
    mt = T.generate_meta(3, res, 2, "Hash", hashmap_size=size)
    x, p_full, _ = _inputs(3, 5 * 7 * 6 * 2, 5, lo=-0.2, hi=1.2)
    p = p_full[:mj.n_params]
    yj = np.asarray(J.lotd_encode(jnp.asarray(x), jnp.asarray(p), mj))
    yt = T.lotd_encode(_t(x), _t(p), mt).numpy()
    np.testing.assert_array_equal(yt, yj)
    yd = T.lotd_encode(_t(x), _t(p_full),
                       T.generate_meta(3, res, 2, "Dense")).numpy()
    assert np.array_equal(yt, yd) == (excess == 0)


def test_batched_clip_crosses_into_the_next_instance():
    """Out-of-domain points of instance b clamp the flat row over the
    whole [B·size, F] table, so they read rows of instance b+1; bidx −1
    gives zeros. The outputs and gradients equal JAX's."""
    mj, mt = _metas(3, "Dense")
    b = 3
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.3, 1.3, (N, 3)).astype(np.float32)
    x[:8] = [1.2, 1.1, 1.25]                 # past the far corner
    p = rng.uniform(-1, 1, (b, mj.n_params)).astype(np.float32)
    bidx = rng.integers(-1, b, N).astype(np.int32)
    bidx[:8] = 0
    yj = J.lotd_encode(jnp.asarray(x), jnp.asarray(p), mj,
                       bidx=jnp.asarray(bidx))
    pt = _t(p).requires_grad_(True)
    yt = T.lotd_encode(_t(x), pt, mt, bidx=_t(bidx))
    _close(yt.detach().numpy(), yj, 1e-6)
    assert not yt[_t(bidx) < 0].any()
    # instance 0's far corner row lies in instance 1: a per-instance
    # clamp would read instance 0's last row instead
    alone = T.lotd_encode(_t(x[:8]), _t(p[0]), mt)
    assert not torch.allclose(yt[:8, 2:], alone[:, 2:])
    gj = jax.grad(lambda pp: jnp.sum(J.lotd_encode(
        jnp.asarray(x), pp, mj, bidx=jnp.asarray(bidx)) ** 2))(
            jnp.asarray(p))
    (gt,) = torch.autograd.grad((yt ** 2).sum(), pt)
    _close(gt.numpy(), gj, 1e-6)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_max_level_and_level_weights_match_jax(as_tensor):
    mj, mt = _metas(3, "Hash")
    x, p, _ = _inputs(3, mj.n_params, 7)
    lw = np.asarray([0.25, 0.75], np.float32)
    ml = torch.tensor(0) if as_tensor else 0
    yj = J.lotd_encode(jnp.asarray(x), jnp.asarray(p), mj,
                       max_level=jnp.asarray(0) if as_tensor else 0,
                       level_weights=jnp.asarray(lw))
    yt = T.lotd_encode(_t(x), _t(p), mt, max_level=ml,
                       level_weights=_t(lw))
    _close(yt.numpy(), yj, 1e-6)
    assert not yt[:, 2:].any() and yt[:, :2].abs().max() > 0


def test_fwd_dydx_and_bwd_dydx_match_jax():
    mj, mt = _metas(3, "VM", smooth=True)
    x, p, g = _inputs(3, mj.n_params, 8)
    g = np.random.default_rng(9).normal(size=(N, mj.out_features)
                                        ).astype(np.float32)
    yj, dj = J.lotd_fwd_dydx(jnp.asarray(x), jnp.asarray(p), mj,
                             max_level=1)
    yt, dt = T.lotd_fwd_dydx(_t(x), _t(p), mt, max_level=1)
    assert dt.shape == (N, mt.out_features, 3)
    _close(yt.numpy(), yj, 1e-6)
    _close(dt.numpy(), dj, 1e-5)
    nj = J.lotd_bwd_dydx(jnp.asarray(g), dj)
    nt = T.lotd_bwd_dydx(_t(g), dt)
    _close(nt.numpy(), nj, 1e-5)
    # the same nablas by reverse mode
    xt = _t(x).requires_grad_(True)
    (gx,) = torch.autograd.grad((T.lotd_encode(xt, _t(p), mt, max_level=1)
                                 * _t(g)).sum(), xt)
    _close(nt.numpy(), gx.numpy(), 1e-5)
