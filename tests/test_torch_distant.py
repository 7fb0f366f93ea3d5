"""Port parity: the distant background (NeRF++'s inverted sphere,
`models/fields_distant.py`) against the JAX package on the CPU:
`inverted_sphere_coords`, `NeRFDistant`, `ray_sphere_exit_t` (a scalar
and a per-sample radius), `nerf_distant_ray_query` (unperturbed and with
JAX's uniforms), `NeRFDistantModel` in both interval types and both sample
modes (unperturbed and with JAX's shell jitter replayed), one train step,
`composite_inner_distant`, and the model of examples/configs/
distant_nerf.yaml. Sizes: the field's defaults (D 3, W 64, 4 frequencies),
24 rays from inside the unit sphere, 16 shells.

The JAX side runs with x64 off (`jax.enable_x64(False)`): it builds its
shells with `jnp.linspace` and draws `jax.random.uniform` without a dtype,
which the suite's x64 would make float64. Weights cross by the state
bridge.

Tolerances: coordinates, exits and the field elementwise (1e-5 relative,
floor 1e-6 of the largest entry); renders within 1e-4 relative on every
ray (no discrete choice here; measured ≤ 3.1e-7 of the largest value);
one step's loss within 1e-4 relative and each gradient within 1e-2
relative L2 (measured: the same loss, gradients ≤ 3.2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models import fields_distant as JD
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.models import fields_distant as TD

torch.set_num_threads(1)

N_RAYS = 24
N_SAMPLES = 16
MODES = [(i, s) for i in ("inverse_proportional", "logarithm")
         for s in ("spherical", "lindisp")]


def _flat_state(model) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(model))}


def _rays(n: int, seed: int):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-1) + 1e-7
    assert float(np.abs(got - want).max()) <= tol, \
        (float(np.abs(got - want).max()), tol)


def _models(**kw):
    with jax.enable_x64(False):
        jm = JD.NeRFDistantModel(n_samples=N_SAMPLES, **kw)
    tm = TD.NeRFDistantModel(n_samples=N_SAMPLES, **kw, device="cpu")
    tm.load_state_dict(from_jax_state(_flat_state(jm)))
    return jm, tm


def test_coords_exit_and_field_match_jax():
    o, d = _rays(N_RAYS, 1)
    x = (o + d * 3.0).astype(np.float32)
    _close(TD.inverted_sphere_coords(torch.from_numpy(x), 1.5).numpy(),
           JD.inverted_sphere_coords(jnp.asarray(x), 1.5))
    for r in (1.2, np.linspace(1.0, 5.0, N_SAMPLES * N_RAYS, dtype=np.float32
                               ).reshape(N_RAYS, N_SAMPLES)):
        tt, vt = TD.ray_sphere_exit_t(torch.from_numpy(o), torch.from_numpy(d),
                                      torch.as_tensor(r))
        tj, vj = JD.ray_sphere_exit_t(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(r))
        _close(tt.numpy(), tj)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    jm, tm = _models()
    oj = jm.field(jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        ot = tm.field(torch.from_numpy(x), torch.from_numpy(d))
    for k in ("sigma", "h", "rgb"):
        _close(ot[k].numpy(), oj[k])


def test_distant_ray_query_matches_jax():
    jm, tm = _models()
    o, d = _rays(N_RAYS, 2)
    far = np.random.default_rng(3).uniform(0.6, 1.4, N_RAYS
                                           ).astype(np.float32)
    key = jax.random.key(4)
    with jax.enable_x64(False):
        u = np.array(jax.random.uniform(key, (N_RAYS, N_SAMPLES)))
        for k, uu in ((None, None), (key, torch.from_numpy(u))):
            rj, vbj = JD.nerf_distant_ray_query(
                jm.field, jnp.asarray(o), jnp.asarray(d), jnp.asarray(far),
                n_samples=N_SAMPLES, perturb_key=k)
            with torch.no_grad():
                rt, vbt = TD.nerf_distant_ray_query(
                    tm.field, torch.from_numpy(o), torch.from_numpy(d),
                    torch.from_numpy(far), n_samples=N_SAMPLES, u=uu)
            _close(vbt["t"].numpy(), vbj["t"])
            for key_ in rj:
                _close(rt[key_].numpy(), rj[key_], rel=1e-4)


@pytest.mark.parametrize("interval,mode", MODES,
                         ids=[f"{i}-{s}" for i, s in MODES])
def test_model_render_matches_jax(interval, mode):
    jm, tm = _models(interval_type=interval, sample_mode=mode,
                     include_inf_distance=(mode == "spherical"))
    o, d = _rays(N_RAYS, 5)
    key = jax.random.key(6)
    with jax.enable_x64(False):
        u = np.array(jax.random.uniform(key, (N_SAMPLES,)))
        for k in (None, key):
            rj, vbj = jm.ray_query(jm.ray_test(jnp.asarray(o),
                                               jnp.asarray(d)), key=k)
            draws = iter([torch.from_numpy(u)])
            with torch.no_grad():
                rt, vbt = tm.ray_query(
                    tm.ray_test(torch.from_numpy(o), torch.from_numpy(d)),
                    draw=None if k is None else
                    (lambda shape, lo, hi: next(draws)))
            assert set(rt) == set(rj)
            _close(vbt["t"].numpy(), vbj["t"])
            for key_ in rj:
                _close(rt[key_].numpy(), rj[key_], rel=1e-4)
    rt_j = jm.ray_test(jnp.asarray(o), jnp.asarray(d))
    rt_t = tm.ray_test(torch.from_numpy(o), torch.from_numpy(d))
    _close(rt_t["near"].numpy(), rt_j["near"])
    assert bool(rt_t["mask"].all()) and np.isinf(rt_t["far"].numpy()).all()


def test_train_step_matches_jax():
    jm, tm = _models()
    o, d = _rays(N_RAYS, 7)
    gt = np.abs(d)
    with jax.enable_x64(False):
        graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

        def loss_fn(p):
            m = nnx.merge(graphdef, p, rest)
            r, _ = m.ray_query(m.ray_test(jnp.asarray(o), jnp.asarray(d)))
            return jnp.mean((r["rgb_volume"] - jnp.asarray(gt)) ** 2)

        jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    jg = {"/".join(str(p) for p in k): np.asarray(v[...])
          for k, v in nnx.to_flat_state(jg)}
    r, _ = tm.ray_query(tm.ray_test(torch.from_numpy(o), torch.from_numpy(d)))
    tl = torch.mean((r["rgb_volume"] - torch.from_numpy(gt)) ** 2)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(jg)
    for k in got:
        err = np.linalg.norm(got[k] - jg[k]) / max(np.linalg.norm(jg[k]),
                                                   1e-12)
        assert err <= 1e-2, (k, err)


def test_composite_inner_distant_matches_jax():
    rng = np.random.default_rng(8)
    inner = {"rgb_volume": rng.uniform(size=(9, 3)).astype(np.float32),
             "mask_volume": rng.uniform(size=9).astype(np.float32),
             "depth_volume": rng.uniform(size=9).astype(np.float32)}
    far = {"rgb_volume": rng.uniform(size=(9, 3)).astype(np.float32),
           "mask_volume": rng.uniform(size=9).astype(np.float32)}
    oj = JD.composite_inner_distant(
        {k: jnp.asarray(v) for k, v in inner.items()},
        {k: jnp.asarray(v) for k, v in far.items()})
    ot = TD.composite_inner_distant(
        {k: torch.from_numpy(v) for k, v in inner.items()},
        {k: torch.from_numpy(v) for k, v in far.items()})
    assert set(ot) == set(oj)
    for k in oj:
        _close(ot[k].numpy(), oj[k])


def test_the_example_config_builds():
    """examples/configs/distant_nerf.yaml's model parameters, the unknown
    modes refused, and device=None meaning the card."""
    import yaml
    from pathlib import Path

    cfg = yaml.safe_load((Path(__file__).resolve().parents[1] / "examples" /
                          "configs" / "distant_nerf.yaml").read_text())
    param = cfg["model"]["param"]
    m = TD.NeRFDistantModel(**param, device="cpu")
    assert (m.interval_type, m.sample_mode, m.n_samples) == \
        ("inverse_proportional", "spherical", 32)
    with pytest.raises(ValueError, match="interval_type"):
        TD.NeRFDistantModel(interval_type="linear", device="cpu")
    with pytest.raises(ValueError, match="sample_mode"):
        TD.NeRFDistantModel(sample_mode="fixed", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TD.NeRFDistantModel(**param)
