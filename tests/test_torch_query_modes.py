"""Port parity: the remaining NeuS and NeRF query modes against the JAX
package on the CPU, at a small size.

* `LoTDNeuSModel` in its default mode, `march_occ_multi_upsample` (the
  mode of examples/train_neus_object.py: two upsample rounds, factors
  [1, 4]), at F=2 and F=4: the render, unperturbed and with JAX's draws
  replayed; at F=4 (the example's --w4) one step of the example (MSE +
  0.03·eikonal over every slab sample's nablas,
  `optax.clip_by_global_norm(5)` then Adam(3e-3)).
* `sphere_trace`: the tracer on three analytic spheres (a hit, a grazing
  hit, a miss; occupancy seeding; a start inside), then the query's
  render and one step, where the band's width carries inv_s's gradient.
* `LoTDNeRFModel` in `march_occ_multi_upsample_compressed` with
  `n_coarse` 0 and 8, unperturbed and with JAX's draws replayed.
* `pretrain_sdf_sphere`, 3 iterations on JAX's points.
* The brick encode's `ho=True` (values and second-order gradients at F=2
  and F=4) and `brick_bwd_dydx`.

Weights cross by the state bridge (tables raised to ±0.1, ln_s to
ln(64)/10, a seeded occupancy grid). `jax.random` cannot be reproduced in
torch: the JAX draws are made in the JAX package's key order and handed
to the port through `draw`. The JAX NeRF reuses the march's key for its
coarse jitter (ROADMAP.md §C): the replay hands the port the draws JAX
made from that key. The sphere trace and the pretrain run their JAX side
with x64 off (the suite's conftest turns it on, and both build float
arrays without a dtype).

Tolerances: the queries make discrete choices (the `cdf <= u` bracket,
the budget cuts, the trace's hit test), so a render must agree within
1e-4 on at least 99% of the rays in every output, one step's loss within
1e-4 relative and each gradient within 1e-2 relative L2, the standard of
PERF.md §2 (the normals and the accumulated weight on 97%: see
`_SHARE`); after clip + Adam each parameter's update within 1e-2 relative
L2 of optax's, and from JAX's gradients the same clip within 1e-6
relative and the same parameters within 1e-7. The tracer's t within
1e-6, its status exact; the band's u is held bitwise against JAX's
formula evaluated in float32. The pretrain's loss within 1e-4 relative
and every parameter within 1e-2·lr (three Adam steps). The brick `ho`
encode is the plain version: values within 1e-6 relative, first order
within 1e-5 relative (floor 1e-6 of the largest entry), second order
within 1e-5 relative with a floor of 1e-5 of the largest entry (its terms
carry (res−2)² and cancel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.model_base import LoTDNeRFModel as JaxNeRF
from nr3d_lib_tpu.models.model_base import LoTDNeuSModel as JaxNeuS
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.models.model_base import LoTDNeRFModel as TorchNeRF
from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel as TorchNeuS
from nr3d_lib_tpu_torch.models.utils import clip_by_global_norm_

torch.set_num_threads(1)

N_RAYS = 128          # a train step's rays
N_RENDER = 512        # a render's rays: one ray is 0.2% of the 99% bar
N_IMP = 8
FACTORS = [1.0, 4.0]
S_MAX = 32
CDF_EPS = 1e-8
LR = 3e-3
EIK = 0.03
ACCEL = {"resolution": 16, "max_steps_per_ray": S_MAX,
         "step_size": 2.0 / S_MAX}
LOTD = {2: {"lod_res": [16, 32, 64], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash"]},
        4: {"lod_res": [16, 64], "lod_n_feats": 4,
            "lod_types": ["Dense", "Hash"]}}


def _enc(n_feats: int) -> dict:
    return {"lotd_cfg": {**LOTD[n_feats], "hashmap_size": 2 ** 16},
            "backend": "brick", "hashmap_rows": 64}


def _neus_cfg(n_feats: int, query: dict) -> dict:
    return dict(
        field_cfg={"surface_cfg": {"encoding_cfg": _enc(n_feats),
                                   "decoder_cfg": {"D": 1, "W": 16}},
                   "radiance_cfg": {"D": 2, "W": 16}},
        accel_cfg=ACCEL, ray_query_cfg=query)


MUP = {"query_mode": "march_occ_multi_upsample",
       "upsample_inv_s_factors": FACTORS, "n_importance": N_IMP}
TRACE = {"query_mode": "sphere_trace"}


def _rays(n: int, seed: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _flat(state) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(state)}


def _seed(jm, table_key: str, occ):
    """Seed the JAX model's table (±0.1), ln_s and occupancy grid; return
    its state as {path: numpy}."""
    flat = _flat(nnx.state(jm))
    rng = np.random.default_rng(0)
    flat[table_key] = rng.uniform(-0.1, 0.1, flat[table_key].shape
                                  ).astype(np.float32)
    if "field/var_ctrl/ln_s" in flat:
        flat["field/var_ctrl/ln_s"] = np.asarray(np.log(64.0) / 10.0,
                                                 np.float32)
    flat["accel/occ/val_grid"] = occ
    state = nnx.state(jm)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(jm, state)
    return flat


def _pair(jcls, tcls, cfg, table_key, occ):
    jm = jcls(**cfg)
    flat = _seed(jm, table_key, occ)
    tm = tcls(**cfg, device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    return jm, tm


def _replay(us):
    """A `draw` that hands out the given uniforms in order, checking each
    shape and range."""
    it = iter(us)

    def draw(shape, lo, hi):
        u = next(it)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        assert lo <= float(u.min()) and float(u.max()) < hi
        return torch.from_numpy(u)
    return draw


def _within(a, b, tol):
    err = np.abs(a - b).reshape(a.shape[0], -1).max(-1)
    return float(np.mean(err <= tol))


# a render's outputs → the share of rays that must agree within 1e-4:
# rgb and depth the standard of PERF.md §2; the accumulated weight and
# the normals (sums of nablas that reach ~1e3 at these tables) move with
# the same few rays and a few more (8 of 512 rays measured in the
# perturbed F=4 render)
_SHARE = {"rgb_volume": 0.99, "depth_volume": 0.99, "depth_surface": 0.99,
          "mask_volume": 0.97, "normals_volume": 0.97}


def _render_close(rt, rj):
    assert set(rt) == set(rj)
    for k in rt:
        assert torch.isfinite(rt[k]).all(), k
        share = _within(rt[k].numpy(), np.asarray(rj[k]), 1e-4)
        assert share >= _SHARE[k], (k, share)
    assert float(rt["mask_volume"].mean()) > 0.1      # not vacuous


def _grad_errors(tm, jgrads):
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(jgrads)
    return {k: float(np.linalg.norm(got[k] - jgrads[k]) /
                     max(np.linalg.norm(jgrads[k]), 1e-12)) for k in got}


def _occ(seed: int = 0):
    return (np.random.default_rng(seed).uniform(size=(16, 16, 16)) < 0.5
            ).astype(np.float32)


# ----------------------------------- NeuS march_occ_multi_upsample
NEUS_TABLE = "field/implicit_surface/encoding/flattened_params"


@pytest.fixture(scope="module", params=[2, 4], ids=["F2", "F4"])
def neus(request):
    return _pair(JaxNeuS, TorchNeuS, _neus_cfg(request.param, MUP),
                 NEUS_TABLE, _occ())


def _mup_uniforms(key, n: int, rounds: int = len(FACTORS)):
    """The marched query's draws in its key order (neus_ray_query.py:
    222-225: the march from the second half of the first split, then one
    draw a round)."""
    pk, km = jax.random.split(key)
    us = [jax.random.uniform(km, (n, S_MAX), jnp.float32)]
    for _ in range(rounds):
        pk, ki = jax.random.split(pk)
        us.append(jax.random.uniform(ki, (n, N_IMP), jnp.float32,
                                     minval=CDF_EPS, maxval=1.0 - CDF_EPS))
    return [np.array(u) for u in us]


def _jax_render(jm, o, d, key):
    graphdef, state = nnx.split(jm)

    @jax.jit
    def render(st, oo, dd):
        m = nnx.merge(graphdef, st)
        return m.ray_query(m.ray_test(oo, dd), key=key)[0]

    return render(state, jnp.asarray(o), jnp.asarray(d))


@pytest.mark.parametrize("perturb", [False, True])
def test_neus_march_occ_multi_upsample_render_matches_jax(neus, perturb):
    jm, tm = neus
    assert "query_mode" in tm.ray_query_cfg
    o, d = _rays(N_RENDER, 1)
    key = jax.random.key(2) if perturb else None
    rj = _jax_render(jm, o, d, key)
    draw = _replay(_mup_uniforms(key, N_RENDER)) if perturb else None
    with torch.no_grad():
        rt, vb = tm.ray_query(tm.ray_test(torch.from_numpy(o),
                                          torch.from_numpy(d)), draw=draw)
    assert vb["t"].shape == (N_RENDER, S_MAX + len(FACTORS) * N_IMP)
    assert vb["nablas"].shape == (N_RENDER, S_MAX + len(FACTORS) * N_IMP, 3)
    _render_close(rt, rj)


def test_neus_default_mode_is_march_occ_multi_upsample(neus):
    """A model built with no ray_query_cfg renders in this mode."""
    _, tm = neus
    cfg = _neus_cfg(tm.field.implicit_surface.encoding.n_feats, {})
    cfg.pop("ray_query_cfg")
    t2 = TorchNeuS(**cfg, device="cpu")
    t2.load_state_dict(tm.state_dict())
    o, d = (torch.from_numpy(a) for a in _rays(16, 3))
    with torch.no_grad():
        _, vb = t2.ray_query(t2.ray_test(o, d))
    assert vb["t"].shape == (16, S_MAX + 3 * 32)     # JAX's default rounds


def _example_loss(rendered, vb, d):
    """examples/train_neus_object.py `loss_fn` with target |d|: MSE +
    0.03 · the mean eikonal over the volume buffer's nablas."""
    lib = torch if isinstance(d, torch.Tensor) else jnp
    norm = (torch.linalg.norm(vb["nablas"], dim=-1) if lib is torch
            else jnp.linalg.norm(vb["nablas"], axis=-1))
    eik = lib.mean((norm - 1.0) ** 2)
    return lib.mean((rendered["rgb_volume"] - lib.abs(d)) ** 2) + EIK * eik


def _check_step(jm, tm, o, d, key, uniforms):
    """One example step: the loss and every gradient against
    `jax.value_and_grad`, the clipped gradients against optax's clip from
    JAX's gradients, the parameters after clip + Adam(3e-3) against
    optax's."""
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
    clipped, _ = optax.clip_by_global_norm(5.0).update(jg, None)
    jgrads, jclip = _flat(jg), _flat(clipped)

    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    rendered, vb = tm.ray_query(
        tm.ray_test(torch.from_numpy(o), torch.from_numpy(d)),
        draw=_replay(uniforms))
    tl = _example_loss(rendered, vb, torch.from_numpy(d))
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    errs = _grad_errors(tm, jgrads)
    assert max(errs.values()) <= 1e-2, errs
    try:
        # from the port's gradients: each parameter's update within 1e-2
        # relative L2 of optax's (the gradients' standard carried
        # through); from JAX's gradients: the same clip and the same
        # update, within 1e-6 relative and 1e-7
        for grads in (None, jgrads):
            with torch.no_grad():
                for k, p in tm.named_parameters():
                    p.copy_(before[k])
                    if grads is not None:
                        p.grad = torch.from_numpy(
                            grads[k.replace(".", "/")].copy())
            clip_by_global_norm_(tm.parameters(), 5.0)
            if grads is not None:
                got = to_jax_paths({k: p.grad
                                    for k, p in tm.named_parameters()})
                for k, v in jclip.items():
                    np.testing.assert_allclose(got[k], v, rtol=1e-6,
                                               atol=1e-12, err_msg=k)
            torch.optim.Adam(tm.parameters(), lr=LR).step()
            after = to_jax_paths(dict(tm.named_parameters()))
            start = to_jax_paths(before)
            for k, v in want.items():
                if grads is None:
                    du, dj = after[k] - start[k], v - start[k]
                    rel = np.linalg.norm(du - dj) / max(np.linalg.norm(dj),
                                                        1e-12)
                    assert rel <= 1e-2, (k, rel)
                else:
                    np.testing.assert_allclose(after[k], v, rtol=0,
                                               atol=1e-7, err_msg=k)
    finally:
        with torch.no_grad():
            for k, p in tm.named_parameters():
                p.copy_(before[k])
                p.grad = None
    return tm


@pytest.fixture(scope="module")
def neus_w4():
    """The F=4 model alone: examples/train_neus_object.py trains --w4."""
    return _pair(JaxNeuS, TorchNeuS, _neus_cfg(4, MUP), NEUS_TABLE, _occ())


def test_neus_example_step_matches_jax(neus_w4):
    jm, tm = neus_w4
    o, d = _rays(N_RAYS, 4)
    key = jax.random.key(5)
    _check_step(jm, tm, o, d, key, _mup_uniforms(key, N_RAYS))
    assert tm.field.var_ctrl.ln_s.grad is None       # restored


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    for scale in (0.1, 10.0):                  # below, then above the max
        jt = {k: jnp.asarray(v * scale) for k, v in tree.items()}
        want, _ = optax.clip_by_global_norm(5.0).update(jt, None)
        ps = [torch.nn.Parameter(torch.zeros(v.shape)) for v in tree.values()]
        for p, v in zip(ps, tree.values()):
            p.grad = torch.from_numpy(v * scale)
        norm = clip_by_global_norm_(ps, 5.0)
        assert abs(float(norm) - float(optax.global_norm(jt))) <= \
            1e-6 * float(norm)
        for p, k in zip(ps, tree):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]),
                                       rtol=1e-6)


# ------------------------------------------------------ the tracer
def _sphere_sdf(lib):
    def sdf(x):
        return lib.linalg.norm(x, axis=-1) - 0.5 if lib is jnp else \
            torch.linalg.norm(x, dim=-1) - 0.5
    return sdf


def _trace_both(o, d, near, far, occ=None, **kw):
    from nr3d_lib_tpu.graphics.sphere_trace import sphere_trace as jtrace
    from nr3d_lib_tpu_torch.graphics.sphere_trace import sphere_trace

    with jax.enable_x64(False):
        oj = jtrace(jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
                    jnp.asarray(far), _sphere_sdf(jnp),
                    occ_grid=None if occ is None else jnp.asarray(occ), **kw)
        oj = {k: np.asarray(v) for k, v in oj.items()}
    ot = sphere_trace(*(torch.from_numpy(a) for a in (o, d, near, far)),
                      _sphere_sdf(torch), occ_grid=None if occ is None
                      else torch.from_numpy(occ), check_every=1, **kw)
    for k in ("t", "sdf", "x"):
        np.testing.assert_allclose(ot[k].numpy(), oj[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(ot["status"].numpy(), oj["status"])
    np.testing.assert_array_equal(ot["hit"].numpy(), oj["hit"])
    return ot


def _f32(*rows):
    return np.asarray(rows, np.float32)


def test_sphere_trace_analytic_sphere_matches_jax():
    from nr3d_lib_tpu_torch.graphics.sphere_trace import RayStatus

    o = _f32([-2.0, 0.0, 0.0], [-2.0, 0.49, 0.0], [-2.0, 0.9, 0.0])
    d = _f32(*[[1.0, 0.0, 0.0]] * 3)
    ot = _trace_both(o, d, np.zeros(3, np.float32),
                     np.full(3, 4.0, np.float32), max_iters=128)
    assert ot["hit"].tolist() == [True, True, False]
    assert abs(float(ot["t"][0]) - 1.5) < 2e-3
    assert abs(float(ot["t"][1]) - (2.0 - np.sqrt(0.25 - 0.49 ** 2))) < 0.05
    assert int(ot["status"][2]) == RayStatus.OUT


def test_sphere_trace_occ_seeding_matches_jax():
    res = 32
    centers = (np.stack(np.meshgrid(*([np.arange(res)] * 3),
                                    indexing="ij"), -1) + 0.5) / res * 2 - 1
    occ = np.abs(np.linalg.norm(centers, axis=-1) - 0.5) < 0.2
    o, d = _f32([-2.0, 0.1, 0.1]), _f32([1.0, 0.0, 0.0])
    ot = _trace_both(o, d, np.zeros(1, np.float32),
                     np.full(1, 4.0, np.float32), occ=occ, max_iters=64)
    assert bool(ot["hit"][0])
    assert abs(float(ot["t"][0]) - (2.0 - np.sqrt(0.25 - 0.02))) < 5e-3


def test_sphere_trace_inside_start_matches_jax():
    ot = _trace_both(_f32([0.0, 0.0, 0.0]), _f32([1.0, 0.0, 0.0]),
                     np.zeros(1, np.float32), np.full(1, 4.0, np.float32))
    assert bool(ot["hit"][0]) and float(ot["t"][0]) == 0.0


def test_sphere_trace_iterations_round_up_to_the_check():
    """The live-ray test every k iterations runs the JAX loop's count
    rounded up to a multiple of k, with the same t bit for bit; k = 0
    runs every iteration."""
    from nr3d_lib_tpu_torch.graphics.sphere_trace import sphere_trace

    o, d = _rays(64, 11)
    args = [torch.from_numpy(o), torch.from_numpy(d),
            torch.zeros(64), torch.full((64,), 4.0)]
    outs = {k: sphere_trace(*args, _sphere_sdf(torch), check_every=k,
                            max_iters=64) for k in (1, 8, 0)}
    n = outs[1]["iters"]
    assert 0 < n < 64
    assert outs[8]["iters"] == min(-(-n // 8) * 8, 64)
    assert outs[0]["iters"] == 64
    for k in (8, 0):
        assert torch.equal(outs[k]["t"], outs[1]["t"])
        assert torch.equal(outs[k]["status"], outs[1]["status"])


def test_band_linspace_is_jax_formula_bitwise():
    """The band's and tail's u: JAX's linspace formula, start·(1 − i/n) +
    stop·i/n in float32 steps with the end point exact, bit for bit.
    (XLA's CPU compiler divides i/n otherwise than IEEE, so jnp.linspace
    itself differs from the formula by up to 2 ulp.)"""
    from nr3d_lib_tpu_torch.graphics.neus_ray_query import linspace_f32

    f = np.float32
    for a, b, n in ((-1.0, 1.0, 16), (0.1, 1.0, 8), (0.0, 1.0, 5),
                    (-1.0, 1.0, 1)):
        div = max(n - 1, 1)
        step = np.arange(n - 1, dtype=f) / f(div)
        want = np.concatenate([f(a) * (f(1) - step) + f(b) * step, [f(b)]]
                              ) if n > 1 else np.asarray([a], f)
        got = linspace_f32(a, b, n).numpy()
        np.testing.assert_array_equal(got, want.astype(f))
        j = np.asarray(jnp.linspace(a, b, n, dtype=jnp.float32))
        assert np.abs(got - j).max() <= 2 * np.spacing(f(1))


# ------------------------------------------------ sphere_trace query
@pytest.fixture(scope="module")
def traced():
    """The F=4 NeuS after JAX's sphere pretrain (a surface to hit), with
    its occupancy grid from its own populate, in sphere_trace mode."""
    from nr3d_lib_tpu.models.fields.sdf import pretrain_sdf_sphere as jpre

    cfg = _neus_cfg(4, TRACE)
    jm = JaxNeuS(**cfg)
    jm.field.var_ctrl.ln_s[...] = jnp.asarray(np.log(64.0) / 10.0,
                                              jnp.float32)
    with jax.enable_x64(False):
        jpre(jm.field.implicit_surface, jax.random.key(0), radius=0.5,
             n_iters=60, n_pts=512, lr=1e-2)
        jm.populate(jax.random.key(1))
    tm = TorchNeuS(**cfg, device="cpu")
    tm.load_state_dict(from_jax_state(_flat(nnx.state(jm))))
    return jm, tm


def _trace_uniforms(key, n_rays: int, n_band: int = 16, n_tail: int = 8):
    kb, kt = jax.random.split(key)
    return [np.array(jax.random.uniform(k, (n_rays, n), jnp.float32, -0.5,
                                        0.5))
            for k, n in ((kb, n_band), (kt, n_tail))]


@pytest.mark.parametrize("perturb", [False, True])
def test_sphere_trace_render_matches_jax(traced, perturb):
    jm, tm = traced
    o, d = _rays(N_RENDER, 6)
    key = jax.random.key(7) if perturb else None
    with jax.enable_x64(False):
        rj = _jax_render(jm, o, d, key)
    draw = _replay(_trace_uniforms(key, N_RENDER)) if perturb else None
    with torch.no_grad():
        rt, vb = tm.ray_query(tm.ray_test(torch.from_numpy(o),
                                          torch.from_numpy(d)), draw=draw)
    assert "depth_surface" in rt and 0 < vb["trace_iters"] <= 64
    assert float(vb["hit"].float().mean()) > 0.5
    _render_close(rt, rj)


def test_sphere_trace_step_matches_jax(traced):
    """One example step in sphere_trace mode: ln_s gets its gradient
    through the band's width as well as through the composite."""
    jm, tm = traced
    o, d = _rays(N_RAYS, 8)
    key = jax.random.key(9)
    with jax.enable_x64(False):
        _check_step(jm, tm, o, d, key, _trace_uniforms(key, N_RAYS))
    # the band's positions themselves depend on ln_s (half_band =
    # band_sigma / inv_s is not detached, as in JAX)
    _, vb = tm.ray_query(tm.ray_test(torch.from_numpy(o),
                                     torch.from_numpy(d)))
    (dt_dlns,) = torch.autograd.grad(vb["t"].sum(), tm.field.var_ctrl.ln_s)
    assert float(dt_dlns) != 0.0


# ------------------------------------------------ NeRF multi-upsample
NERF_MUP = {"query_mode": "march_occ_multi_upsample_compressed",
            "compression_factor": 0.5, "n_fine": 8}


def _nerf_cfg(n_coarse: int) -> dict:
    return dict(field_cfg={"encoding_cfg": _enc(2),
                           "density_decoder_cfg": {"D": 1, "W": 16},
                           "radiance_cfg": {"D": 2, "W": 16}},
                accel_cfg=ACCEL,
                ray_query_cfg={**NERF_MUP, "n_coarse": n_coarse})


@pytest.fixture(scope="module", params=[0, 8], ids=["coarse0", "coarse8"])
def nerf(request):
    return _pair(JaxNeRF, TorchNeRF, _nerf_cfg(request.param),
                 "field/encoding/flattened_params", _occ(1))


def _nerf_uniforms(key, n: int, n_coarse: int):
    """JAX's draws: the march and the coarse jitter both from the march
    key (nerf_ray_query.py:186-188), the CDF quantiles from the other."""
    km, ku = jax.random.split(key)
    us = [jax.random.uniform(km, (n, S_MAX), jnp.float32)]
    if n_coarse:
        us.append(jax.random.uniform(km, (n, n_coarse), jnp.float32))
    us.append(jax.random.uniform(ku, (n, NERF_MUP["n_fine"]),
                                 jnp.float32, CDF_EPS, 1.0 - CDF_EPS))
    return [np.array(u) for u in us]


@pytest.mark.parametrize("perturb", [False, True])
def test_nerf_multi_upsample_render_matches_jax(nerf, perturb):
    jm, tm = nerf
    n_coarse = tm.ray_query_cfg["n_coarse"]
    o, d = _rays(N_RENDER, 10)
    key = jax.random.key(11) if perturb else None
    rj = _jax_render(jm, o, d, key)
    draw = _replay(_nerf_uniforms(key, N_RENDER, n_coarse)) if perturb else None
    with torch.no_grad():
        rt, vb = tm.ray_query(tm.ray_test(torch.from_numpy(o),
                                          torch.from_numpy(d)), draw=draw)
    b2 = int((S_MAX // 2 + n_coarse + NERF_MUP["n_fine"]) * 0.5)
    assert vb["t"].shape == (N_RENDER, b2)
    assert int(vb["n_compact"]) > N_RENDER
    _render_close(rt, rj)


def test_unknown_mode_raises_value_error():
    for cls, cfg in ((TorchNeuS, _neus_cfg(2, {"query_mode": "bogus"})),
                     (TorchNeRF, {**_nerf_cfg(0),
                                  "ray_query_cfg": {"query_mode": "bogus"}})):
        with pytest.raises(ValueError, match="Unknown query_mode: bogus"):
            cls(**cfg, device="cpu").ray_query({})


# ------------------------------------------------------ the pretrain
def test_pretrain_sdf_sphere_matches_jax():
    from nr3d_lib_tpu.models.fields.sdf import pretrain_sdf_sphere as jpre
    from nr3d_lib_tpu_torch.models.fields.sdf import pretrain_sdf_sphere

    cfg = _neus_cfg(4, MUP)
    jm = JaxNeuS(**cfg)
    flat = _seed(jm, NEUS_TABLE, _occ())
    tm = TorchNeuS(**cfg, device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    n_iters, n_pts, lr = 3, 256, 1e-2
    with jax.enable_x64(False):
        key, pts = jax.random.key(0), []
        for _ in range(n_iters):       # the function's own key chain
            key, sub = jax.random.split(key)
            pts.append(np.array(jax.random.uniform(
                sub, (n_pts, 3), minval=-1.0, maxval=1.0)))
        jl = jpre(jm.field.implicit_surface, jax.random.key(0), radius=0.5,
                  n_iters=n_iters, n_pts=n_pts, lr=lr)
    assert all(p.dtype == np.float32 for p in pts)

    tl = pretrain_sdf_sphere(tm.field.implicit_surface, radius=0.5,
                             n_iters=n_iters, n_pts=n_pts, lr=lr,
                             draw=_replay(pts))
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    want = _flat(nnx.state(jm.field.implicit_surface, nnx.Param))
    got = to_jax_paths(dict(tm.field.implicit_surface.named_parameters()))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-2 * lr,
                                   err_msg=k)


# ------------------------------------------- brick ho and bwd_dydx
BRICK_METAS = {2: ([8, 16, 32], ["Dense", "Dense", "Hash"]),
               4: ([8, 32], ["Dense", "Hash"])}


def _brick_ops(n_feats: int):
    if n_feats == 2:
        from nr3d_lib_tpu.ops import lotd_brick as J
        from nr3d_lib_tpu_torch.ops import lotd_brick as T
        return (J.make_brick_meta, T.make_brick_meta, J.brick_encode_ho,
                T.brick_encode_ho, 128)
    from nr3d_lib_tpu.ops import lotd_brick4 as J4
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as T4
    return (J4.make_brick4_meta, T4.make_brick4_meta, J4.brick4_encode_xla,
            T4.brick4_encode_xla, 256)


def _close(got, want, rtol, floor=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=floor * float(np.abs(want).max()))


@pytest.mark.parametrize("n_feats", [2, 4], ids=["F2", "F4"])
def test_brick_ho_second_order_matches_jax(n_feats):
    """The ho encode's values, its x-gradient, and the gradient of that
    gradient's squared norm into x and the table."""
    jmake, tmake, jenc, tenc, width = _brick_ops(n_feats)
    lod_res, types = BRICK_METAS[n_feats]
    jmeta, tmeta = jmake(lod_res, types, 64), tmake(lod_res, types, 64)
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    table = rng.uniform(-0.1, 0.1, (tmeta.total_rows, width)
                        ).astype(np.float32)
    w = rng.standard_normal((256, n_feats * len(lod_res))).astype(np.float32)

    def jg(xx, tt):
        return jax.grad(lambda a: jnp.sum(jenc(a, tt, jmeta) * w))(xx)

    jy = jenc(jnp.asarray(x), jnp.asarray(table), jmeta)
    jgx = jg(jnp.asarray(x), jnp.asarray(table))
    j2x, j2t = jax.grad(lambda a, b: jnp.sum(jg(a, b) ** 2), (0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    y = tenc(xt, tt, tmeta)
    _close(y, jy, 1e-6)
    (gx,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xt,
                                create_graph=True)
    _close(gx, jgx, 1e-5)
    g2x, g2t = torch.autograd.grad((gx ** 2).sum(), (xt, tt))
    _close(g2x, j2x, 1e-5, floor=1e-5)
    _close(g2t, j2t, 1e-5, floor=1e-5)


def test_brick_bwd_dydx_matches_jax():
    from nr3d_lib_tpu.ops import lotd_brick as J
    from nr3d_lib_tpu_torch.ops import lotd_brick as T

    lod_res, types = BRICK_METAS[2]
    jmeta, tmeta = J.make_brick_meta(lod_res, types, 64), \
        T.make_brick_meta(lod_res, types, 64)
    rng = np.random.default_rng(13)
    x = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    table = rng.uniform(-0.1, 0.1, (tmeta.total_rows, 128)).astype(np.float32)
    g = rng.standard_normal((512, 6)).astype(np.float32)
    want = J.brick_bwd_dydx(jnp.asarray(g), jnp.asarray(x),
                            jnp.asarray(table), jmeta)
    got = T.brick_bwd_dydx(torch.from_numpy(g), torch.from_numpy(x),
                           torch.from_numpy(table), tmeta)
    _close(got, want, 1e-5)
    assert not got.requires_grad
    # the same as the nablas kernel's plain version
    _close(got, T.brick_nablas_xla(*(torch.from_numpy(a)
                                     for a in (g, x, table)), tmeta).numpy(),
           1e-6)
