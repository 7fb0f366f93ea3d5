"""Port parity: the classic LoTD module (`LoTDEncoding`), its auto-config
functions, the per-level helpers and the gradient guard, against the JAX
package's on the CPU.

* `LoTDEncoding` from the JAX module's bridged `flattened_params`: the
  forward, `forward_dydx` (× 0.5 for the [-1,1] input) and
  `backward_dydx`, with the hardmask and the cosine anneal stepped
  through `set_anneal_iter` (JAX's cosine window is set through
  `nnx.data`: its module refuses it, ROADMAP.md §C); `lotd_auto_compute_cfg`; the init's bound;
  `get/set_level_param`; the factory `get_lotd_encoding` (the default
  and any backend but 'brick' build the classic module, as in JAX).
* `auto_ngp_cfg`, `auto_ngp4d_cfg`, `get_lotd_cfg`: equal dicts.
* `level_param_shape`, `get_level_param` (flat and batched),
  `set_level_param`, `param_interpolate` up and down, `GradGuard` over a
  sequence of gradients with a spike.

Tolerances: the encoding keeps JAX's sum order (values within 1e-6 of
the largest entry; the forward-mode Jacobian within 1e-5). JAX's
`param_interpolate` runs its `linspace` in float64 here (the conftest
turns on x64) and the port its formula in float32: within 1e-6 of the
largest entry. The guard's norms within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.grid_encodings.lotd import lotd_cfg as JC
from nr3d_lib_tpu.models.grid_encodings.lotd import lotd_helpers as JH
from nr3d_lib_tpu.models.grid_encodings.lotd.lotd_encoding import \
    LoTDEncoding as JaxEnc
from nr3d_lib_tpu.ops import lotd as JL
from nr3d_lib_tpu_torch.models.grid_encodings.lotd import (
    LoTDBrickEncoding, LoTDEncoding, get_lotd_encoding)
from nr3d_lib_tpu_torch.models.grid_encodings.lotd import lotd_cfg as TC
from nr3d_lib_tpu_torch.models.grid_encodings.lotd import lotd_helpers as TH
from nr3d_lib_tpu_torch.ops import lotd as TL

torch.set_num_threads(1)

CFG = {"lod_res": [6, [9, 7, 11], 17], "lod_n_feats": [2, 4, 2],
       "lod_types": ["Dense", "VM", "Hash"], "hashmap_size": 256}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-12), err


def _pair(**kw):
    je = JaxEnc(3, lotd_cfg=CFG, seed=1, **kw)
    p = np.random.default_rng(0).uniform(
        -0.5, 0.5, je.meta.n_params).astype(np.float32)
    je.flattened_params[...] = jnp.asarray(p)
    te = LoTDEncoding(3, lotd_cfg=CFG, seed=1, device="cpu", **kw)
    te.load_state_dict({"flattened_params": _t(p)})
    return je, te


@pytest.mark.parametrize("anneal", [None, "hardmask", "cosine"])
def test_encoding_matches_jax(anneal):
    kw = {} if anneal is None else \
        {"anneal_cfg": {"stop_it": 9, "start_level": 1, "type": anneal}}
    je, te = _pair(**kw)
    assert te.out_features == je.out_features == 8
    x = np.random.default_rng(1).uniform(-1.1, 1.1, (200, 3)
                                         ).astype(np.float32)
    g = np.random.default_rng(2).normal(size=(200, 8)).astype(np.float32)
    for it in ([None] if anneal is None else [0, 4, 20]):
        if it is not None:
            te.set_anneal_iter(it)
            if anneal == "cosine":
                # JAX's module cannot hold its window (flax nnx refuses
                # the array on a static attribute: ROADMAP.md §C); its
                # pieces give the same
                ml, w = je.annealer(it)
                je.max_level, je.level_weights = ml, nnx.data(
                    jnp.asarray(w))
                np.testing.assert_array_equal(te.level_weights.numpy(), w)
            else:
                je.set_anneal_iter(it)
            assert te.max_level == je.max_level
        _close(te(_t(x)), je(jnp.asarray(x)), 1e-6)
        yj, dj = je.forward_dydx(jnp.asarray(x))
        yt, dt = te.forward_dydx(_t(x))
        _close(yt, yj, 1e-6)
        _close(dt, dj, 1e-5)
        _close(te.backward_dydx(_t(g), dt),
               je.backward_dydx(jnp.asarray(g), dj), 1e-5)
    if anneal == "hardmask":
        _close(te(_t(x), max_level=0),
               je(jnp.asarray(x), max_level=0), 1e-6)


def test_encoding_state_init_and_level_params():
    je, te = _pair()
    assert list(te.state_dict()) == ["flattened_params"]
    assert te.flattened_params.shape == (je.meta.n_params,)
    for lv in range(3):
        np.testing.assert_array_equal(te.get_level_param(lv).detach().numpy(),
                                      np.asarray(je.get_level_param(lv)))
    v = np.full(je.meta.level_n_params[1], 0.25, np.float32)
    je.set_level_param(1, jnp.asarray(v))
    te.set_level_param(1, _t(v))
    np.testing.assert_array_equal(te.flattened_params.detach().numpy(),
                                  np.asarray(je.flattened_params[...]))
    fresh = LoTDEncoding(3, lotd_cfg=CFG, seed=3, device="cpu")
    p = fresh.flattened_params.detach()
    assert 0 < float(p.abs().max()) <= 1e-4
    normal = LoTDEncoding(3, lotd_cfg=CFG, seed=3, device="cpu",
                          param_init_cfg={"method": "normal", "std": 0.1})
    assert 0.08 < float(normal.flattened_params.detach().std()) < 0.12


def test_auto_compute_cfg_matches_jax():
    auto = {"type": "ngp", "n_levels": 4, "min_res": 4,
            "log2_hashmap_size": 14, "target_num_params": 2 ** 16}
    aabb = [[-1.0, -0.5, -2.0], [1.0, 0.5, 2.0]]
    je = JaxEnc(3, lotd_auto_compute_cfg=auto, aabb=aabb)
    te = LoTDEncoding(3, lotd_auto_compute_cfg=auto, aabb=aabb,
                      device="cpu")
    assert te.meta.level_res == je.meta.level_res
    assert te.meta.level_sizes == je.meta.level_sizes
    assert te.meta.n_params == je.meta.n_params


def test_get_lotd_encoding_backends():
    """Any backend but 'brick' is the classic module, with kwargs passed
    on (an unknown one raises, as JAX's does)."""
    lc = {"lod_res": [8, 16], "lod_types": ["Dense", "Hash"],
          "hashmap_size": 2 ** 12}
    for kw in ({}, {"backend": "xla"}, {"backend": "other"}):
        enc = get_lotd_encoding(3, lotd_cfg=lc, device="cpu", **kw)
        assert isinstance(enc, LoTDEncoding) and enc.meta.level_sizes == \
            (512, 2 ** 12)
    enc = get_lotd_encoding(3, lotd_cfg=lc, device="cpu",
                            anneal_cfg={"stop_it": 4})
    enc.set_anneal_iter(0)
    assert enc.max_level == 0
    assert isinstance(get_lotd_encoding(3, lotd_cfg=lc, backend="brick",
                                        hashmap_rows=64, device="cpu"),
                      LoTDBrickEncoding)
    with pytest.raises(TypeError):
        get_lotd_encoding(3, lotd_cfg=lc, frozen_x=True, device="cpu")


CFG_CASES = [
    ("ngp", dict(stretch=2.0)),
    ("ngp", dict(stretch=[4.0, 1.0, 2.0], n_levels=8, max_res=64)),
    ("auto_ngp", dict(stretch=1.0, log2_hashmap_size=22,
                      target_num_params=2 ** 18, dense_until_params=2 ** 12)),
    ("ngp4d", dict(stretch=[2.0, 1.0, 1.0], input_ch=4)),
    ("auto_ngp4d", dict(stretch=1.0, input_ch=3, min_dense_levels=2,
                        target_num_params=2 ** 20)),
]


@pytest.mark.parametrize("kind,kw", CFG_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(CFG_CASES)])
def test_lotd_cfg_matches_jax(kind, kw):
    assert TC.get_lotd_cfg(kind, **kw) == JC.get_lotd_cfg(kind, **kw)


def test_cfg_functions_match_jax():
    assert TC.auto_ngp_cfg([1.0, 3.0], input_ch=2) == \
        JC.auto_ngp_cfg([1.0, 3.0], input_ch=2)
    assert TC.auto_ngp4d_cfg(2.0, min_res_w=8) == \
        JC.auto_ngp4d_cfg(2.0, min_res_w=8)
    with pytest.raises(ValueError):
        TC.get_lotd_cfg("bogus")


def test_level_param_helpers_match_jax():
    mj = JL.generate_meta(3, CFG["lod_res"], CFG["lod_n_feats"],
                          CFG["lod_types"], hashmap_size=256)
    mt = TL.generate_meta(3, CFG["lod_res"], CFG["lod_n_feats"],
                          CFG["lod_types"], hashmap_size=256)
    rng = np.random.default_rng(4)
    p = rng.normal(size=mj.n_params).astype(np.float32)
    pb = rng.normal(size=(3, mj.n_params)).astype(np.float32)
    for lv in range(3):
        assert TH.level_param_shape(mt, lv) == JH.level_param_shape(mj, lv)
        np.testing.assert_array_equal(
            TH.get_level_param(_t(p), mt, lv).numpy(),
            np.asarray(JH.get_level_param(jnp.asarray(p), mj, lv)))
        np.testing.assert_array_equal(
            TH.get_level_param(_t(pb), mt, lv, batched=True).numpy(),
            np.asarray(JH.get_level_param(jnp.asarray(pb), mj, lv,
                                          batched=True)))
    v = rng.normal(size=mj.level_n_params[2]).astype(np.float32)
    got = TH.set_level_param(_t(p), mt, 2, _t(v))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JH.set_level_param(jnp.asarray(p), mj, 2,
                                                   jnp.asarray(v))))
    assert not torch.equal(got, _t(p))            # a copy


@pytest.mark.parametrize("new_res", [(13, 9, 21), (4, 3, 5)],
                         ids=["up", "down"])
def test_param_interpolate_matches_jax(new_res):
    lp = np.random.default_rng(5).normal(size=(7, 6, 9, 2)
                                         ).astype(np.float32)
    want = JH.param_interpolate(jnp.asarray(lp), new_res)
    got = TH.param_interpolate(_t(lp), new_res)
    assert got.shape == tuple(new_res) + (2,) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-6)


def test_grad_guard_matches_jax():
    rng = np.random.default_rng(6)
    base = [rng.normal(size=(5, 3)).astype(np.float32),
            rng.normal(size=7).astype(np.float32)]
    jg, tg = JH.GradGuard(ema_decay=0.9, ema_factor=3.0), \
        TH.GradGuard(ema_decay=0.9, ema_factor=3.0)
    flags = []
    for scale in (1.0, 1.2, 50.0, 0.8):
        ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in base]
        for p, g in zip(ps, base):
            p.grad = _t(g * scale)
        want, cj = jg({"a": jnp.asarray(base[0] * scale),
                       "b": jnp.asarray(base[1] * scale)})
        got, ct = tg(ps)
        assert ct == cj
        flags.append(ct)
        assert got[0] is ps[0].grad
        for g, k in zip(got, ("a", "b")):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                       rtol=1e-6)
        assert abs(tg.ema_norm - jg.ema_norm) <= 1e-6 * jg.ema_norm
    assert flags == [False, False, True, False]
