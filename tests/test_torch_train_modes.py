"""Port parity: the NeRF and NeuS train steps of experiments/bench_render.py
`main_train` against the JAX package on the CPU, at a small size.

* `main_train(kind="nerf")`: `nerf_ray_query_fixed` over the F=2 brick
  LoTD NeRF (three levels, a 64-row hash, decoder and radiance width 16,
  128 rays × 32 stratified samples), MSE(rgb, |d|); the density path runs
  the frozen-x encode, so its backward gives dL/dtable only.
* `main_train(kind="neus")`: `LoTDNeuSModel.ray_query` in the
  `coarse_multi_upsample` mode over the F=2 brick NeuS (three levels,
  width 16, 128 rays, 16 coarse samples and 8 importance samples in each
  of three rounds), MSE + 0.1·eikonal over every queried nablas.

Weights cross by the state bridge (the table raised to ±0.1, ln_s to
ln(64)/10). `jax.random` cannot be reproduced in torch: the JAX package's
uniforms are drawn in its key split order and handed to the port through
the query's `draw`.

Tolerances: the fixed NeRF query makes no discrete choice, so the render
agrees ray by ray within 1e-5, the loss within 1e-5 relative and each
gradient within 1e-4 relative L2 (float32 sums in another order). The
NeuS query's upsampling brackets `cdf <= u` and can move a ray's samples
on a last-ulp difference (PERF.md §2): its render must agree within 1e-4
on at least 99% of the rays, and one step's loss within 1e-4 relative and
each gradient within 1e-2 relative L2, the standard of the train-step
test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.graphics.nerf_ray_query import nerf_ray_query_fixed as jfixed
from nr3d_lib_tpu.models.model_base import LoTDNeRFModel as JaxNeRF
from nr3d_lib_tpu.models.model_base import LoTDNeuSModel as JaxNeuS
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.graphics.nerf_ray_query import \
    nerf_ray_query_fixed as tfixed
from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss
from nr3d_lib_tpu_torch.models.model_base import LoTDNeRFModel as TorchNeRF
from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel as TorchNeuS

torch.set_num_threads(1)

N_RAYS = 128
N_SAMPLES = 32
N_COARSE = 16
N_IMP = 8
CDF_EPS = 1e-8
ENC = {"lotd_cfg": {"lod_res": [8, 16, 32], "lod_n_feats": 2,
                    "lod_types": ["Dense", "Dense", "Hash"],
                    "hashmap_size": 2 ** 15},
       "backend": "brick", "hashmap_rows": 64}
NERF = dict(field_cfg={"encoding_cfg": ENC,
                       "density_decoder_cfg": {"D": 1, "W": 16},
                       "radiance_cfg": {"D": 2, "W": 16}})
NEUS = dict(field_cfg={"surface_cfg": {"encoding_cfg": ENC,
                                       "decoder_cfg": {"D": 1, "W": 16}},
                       "radiance_cfg": {"D": 2, "W": 16}},
            ray_query_cfg={"query_mode": "coarse_multi_upsample",
                           "n_coarse": N_COARSE, "n_importance": N_IMP})


def _rays(n: int, seed: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _seeded(jm, table_key: str):
    """Seed the JAX model's table (±0.1) and ln_s; return its state as
    {path: numpy}."""
    flat = {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(jm))}
    rng = np.random.default_rng(0)
    flat[table_key] = rng.uniform(-0.1, 0.1, flat[table_key].shape
                                  ).astype(np.float32)
    if "field/var_ctrl/ln_s" in flat:
        flat["field/var_ctrl/ln_s"] = np.asarray(np.log(64.0) / 10.0,
                                                 np.float32)
    state = nnx.state(jm)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(jm, state)
    return flat


def _replay(us):
    """A `draw` that hands out the given uniforms in order."""
    it = iter(us)

    def draw(shape, lo, hi):
        u = next(it)
        assert tuple(u.shape) == tuple(shape)
        assert lo <= float(u.min()) and float(u.max()) < max(hi, 1.0)
        return torch.from_numpy(u)
    return draw


def _grad_errors(tm, jgrads):
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(jgrads)
    return {k: float(np.linalg.norm(got[k] - jgrads[k]) /
                     max(np.linalg.norm(jgrads[k]), 1e-12)) for k in got}


def _flat(g) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(g)}


# ------------------------------------------------------------- the NeRF
@pytest.fixture(scope="module")
def nerf():
    jm = JaxNeRF(**NERF)
    flat = _seeded(jm, "field/encoding/flattened_params")
    tm = TorchNeRF(**NERF, device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    return jm, tm


def _nerf_uniforms(key):
    return [np.array(jax.random.uniform(key, (N_RAYS, N_SAMPLES),
                                        jnp.float32))]


@pytest.mark.parametrize("perturb", [False, True])
def test_nerf_fixed_render_matches_jax(nerf, perturb):
    jm, tm = nerf
    o, d = _rays(N_RAYS, 1)
    key = jax.random.key(3) if perturb else None
    graphdef, state = nnx.split(jm)

    @jax.jit
    def render(st, oo, dd):
        m = nnx.merge(graphdef, st)
        return jfixed(m, m.space, m.space.ray_test(oo, dd),
                      n_samples=N_SAMPLES, perturb_key=key)[0]

    rj = render(state, jnp.asarray(o), jnp.asarray(d))
    draw = _replay(_nerf_uniforms(key)) if perturb else None
    with torch.no_grad():
        ot, dt = torch.from_numpy(o), torch.from_numpy(d)
        rt, _ = tfixed(tm, tm.space, tm.space.ray_test(ot, dt),
                       n_samples=N_SAMPLES, draw=draw)
    assert set(rt) == set(rj)
    for k in rt:
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert float(rt["mask_volume"].mean()) > 0.1      # not vacuous


def test_nerf_fixed_step_matches_jax(nerf):
    """One step of main_train(kind="nerf"): loss and every gradient."""
    jm, tm = nerf
    o, d = _rays(N_RAYS, 2)
    key = jax.random.key(4)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p, oo, dd):
        m = nnx.merge(graphdef, p, rest)
        rendered, _ = jfixed(m, m.space, m.space.ray_test(oo, dd),
                             n_samples=N_SAMPLES, perturb_key=key)
        return jnp.mean((rendered["rgb_volume"] - jnp.abs(dd)) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params, jnp.asarray(o),
                                                   jnp.asarray(d))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    tm.zero_grad(set_to_none=True)
    rendered, _ = tfixed(tm, tm.space, tm.space.ray_test(ot, dt),
                         n_samples=N_SAMPLES,
                         draw=_replay(_nerf_uniforms(key)))
    tl = torch.mean((rendered["rgb_volume"] - dt.abs()) ** 2)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    errs = _grad_errors(tm, _flat(jg))
    assert max(errs.values()) <= 1e-4, errs
    assert tm.field.encoding.flattened_params.grad.abs().max() > 0


# ------------------------------------------------------------- the NeuS
@pytest.fixture(scope="module")
def neus():
    jm = JaxNeuS(**NEUS)
    flat = _seeded(jm, "field/implicit_surface/encoding/flattened_params")
    tm = TorchNeuS(**NEUS, device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    return jm, tm


def _neus_uniforms(key, rounds: int = 3):
    """The coarse query's draws in its key split order
    (neus_ray_query.py:133-140, then one per upsample round)."""
    pk, kc = jax.random.split(key)
    us = [jax.random.uniform(kc, (N_RAYS, N_COARSE), jnp.float32)]
    for _ in range(rounds):
        pk, ki = jax.random.split(pk)
        us.append(jax.random.uniform(ki, (N_RAYS, N_IMP), jnp.float32,
                                     minval=CDF_EPS, maxval=1.0 - CDF_EPS))
    return [np.array(u) for u in us]


def _within(a, b, tol):
    """Share of rays whose every entry agrees within tol."""
    err = np.abs(a - b).reshape(a.shape[0], -1).max(-1)
    return float(np.mean(err <= tol))


@pytest.mark.parametrize("perturb", [False, True])
def test_neus_coarse_render_matches_jax(neus, perturb):
    jm, tm = neus
    o, d = _rays(N_RAYS, 5)
    key = jax.random.key(6) if perturb else None
    graphdef, state = nnx.split(jm)

    @jax.jit
    def render(st, oo, dd):
        m = nnx.merge(graphdef, st)
        return m.ray_query(m.ray_test(oo, dd), key=key)[0]

    rj = render(state, jnp.asarray(o), jnp.asarray(d))
    draw = _replay(_neus_uniforms(key)) if perturb else None
    with torch.no_grad():
        rt, vb = tm.ray_query(tm.ray_test(torch.from_numpy(o),
                                          torch.from_numpy(d)), draw=draw)
    assert set(rt) == set(rj)
    assert vb["t"].shape == (N_RAYS, N_COARSE + 3 * N_IMP)
    for k in rt:
        assert torch.isfinite(rt[k]).all(), k
        share = _within(rt[k].numpy(), np.asarray(rj[k]), 1e-4)
        assert share >= 0.99, (k, share)
    assert float(rt["mask_volume"].mean()) > 0.1


def test_neus_coarse_step_matches_jax(neus):
    """One step of main_train(kind="neus"): MSE + 0.1·eikonal over every
    queried nablas, loss and every gradient."""
    jm, tm = neus
    o, d = _rays(N_RAYS, 7)
    key = jax.random.key(8)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p, oo, dd):
        m = nnx.merge(graphdef, p, rest)
        rendered, vb = m.ray_query(m.ray_test(oo, dd), key=key)
        loss = jnp.mean((rendered["rgb_volume"] - jnp.abs(dd)) ** 2)
        err = (jnp.linalg.norm(vb["nablas"], axis=-1) - 1.0) ** 2
        return loss + 0.1 * jnp.mean(err)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params, jnp.asarray(o),
                                                   jnp.asarray(d))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    tm.zero_grad(set_to_none=True)
    rendered, vb = tm.ray_query(tm.ray_test(ot, dt),
                                draw=_replay(_neus_uniforms(key)))
    tl = torch.mean((rendered["rgb_volume"] - dt.abs()) ** 2) + \
        0.1 * eikonal_loss(vb["nablas"].reshape(-1, 3))
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    errs = _grad_errors(tm, _flat(jg))
    assert max(errs.values()) <= 1e-2, errs
    assert tm.field.var_ctrl.ln_s.grad.abs() > 0


def test_other_neus_modes_render(neus):
    """The other NeuS modes render on the coarse model's weights, and the
    default mode with no ray_query_cfg is `march_occ_multi_upsample`
    (their parity is in test_torch_query_modes.py); an unknown mode raises
    as in JAX."""
    _, tm = neus
    o, d = (torch.from_numpy(a) for a in _rays(16, 31))
    for query in ({"query_mode": "sphere_trace"}, {}):
        tm2 = TorchNeuS(**{**NEUS, "ray_query_cfg": query}, device="cpu")
        tm2.load_state_dict(tm.state_dict())
        with torch.no_grad():
            r2, vb2 = tm2.ray_query(tm2.ray_test(o, d))
        assert all(bool(torch.isfinite(v).all()) for v in r2.values())
        assert ("trace_iters" in vb2) == bool(query)
    tm2.ray_query_cfg = {"query_mode": "bogus"}
    with pytest.raises(ValueError, match="Unknown query_mode: bogus"):
        tm2.ray_query({})
