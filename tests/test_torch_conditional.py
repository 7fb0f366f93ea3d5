"""Port parity: the conditional families against the JAX package on the
CPU, at a small size — the embeddings and the autodecoder, the batched
spaces, the generative permuto field on the classic lattice at d = 3 + 4
= 7 (examples/train_generative_shapes.py's) and on the F=2 cell layout
at d = 3 + 2 = 5 (JAX through its off-TPU XLA route, the port through
its plain versions on CPU tensors), `GenerativePermutoNeuSModelBatched`,
`DynamicGenerativeNeuSModel` (d = 3 + 4 + 1 = 8,
examples/train_conditional_dynamic.py's) and `StyleLoTDNeuSModelBatched`
(the flatten grower over a [4, 8] LoTD): their renders, which go through
`neus_ray_query_batched` (both `per_instance_z` modes) and
`neus_ray_query_batched_dynamic`, and one train step each. Also the
FiLM-SIREN modulations (`models/modulations.py`, latents per row and per
point) and the error-map importance sampler (`models/importance.py`:
collect, the CDFs, `sample_pixel` from JAX's uniforms; its JAX side with
x64 off, as it draws without a dtype).

Sizes: permuto res [4, 8] at 2^10 entries a level (cell: 256 rows a
level), decoder W 16, radiance D 1 W 16, 4 instances, 40 rays of which a
few have bidx −1, 16 coarse samples and two upsample rounds of 8.

Weights cross by the state bridge (`bridge.from_jax_state`: the
autodecoder's `autodecoder/latents/weight`, the banks'
`bank/flattened_params`, the grower's `grower/mlp/...`); tables are
raised to ±0.1, latents drawn N(0, 0.3²), ln_s = ln(64)/10. The JAX
draws are made in its key split order (coarse samples, then one per
upsample round) and handed to the port's `draw`.

Tolerances: fields, embeddings and spaces elementwise (1e-5 relative,
floor 1e-6 of the largest entry; integers exactly); renders ray by ray,
at least 99% of rays within 1e-4 on rgb, depth and mask (measured: all
rays within 6e-7, the style model's within 4.3e-6); one step's loss (rgb
MSE + 0.03·eikonal + 1e-4·the latent prior, the examples' loss) within
1e-4 relative and each gradient within 1e-2 relative L2 (measured: loss
≤ 1.9e-6, gradients ≤ 6.7e-5 on the permuto models, 1.2e-4 on the style
model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models import model_families as JM
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.models import model_families as TM

torch.set_num_threads(1)

N_RAYS = 40
N_COARSE = 16
N_IMP = 8
N_INST = 4
CDF_EPS = 1e-8
PERMUTO = {"res_list": [4.0, 8.0], "n_feats": 2, "log2_hashmap_size": 10}
CELL = {"res_list": [4.0, 8.0], "backend": "cell", "hashmap_rows": 256}
QUERY = {"n_coarse": N_COARSE, "upsample_inv_s_factors": [1.0, 4.0],
         "n_importance": N_IMP}


def _cfg(permuto=PERMUTO, latent_dim: int = 4) -> dict:
    return dict(n_instances=N_INST, latent_dim=latent_dim, latent_std=0.1,
                field_cfg={"surface_cfg": {"permuto_cfg": permuto,
                                           "decoder_cfg": {"D": 1, "W": 16}},
                           "radiance_cfg": {"D": 1, "W": 16}},
                ray_query_cfg=QUERY)


STYLE_CFG = dict(n_instances=N_INST, latent_dim=8,
                 field_cfg={"surface_cfg": {
                     "lotd_cfg": {"lod_res": [4, 8], "lod_n_feats": 2,
                                  "lod_types": "Dense"},
                     "grower_cfg": {"D": 1, "W": 32, "out_scale": 1.0},
                     "decoder_cfg": {"D": 1, "W": 16}},
                     "radiance_cfg": {"D": 1, "W": 16}},
                 ray_query_cfg=QUERY)

# name → (JAX class, port class, config, per-ray extras)
MODELS = {
    "gen_d7": ("GenerativePermutoNeuSModelBatched", _cfg(), ("bidx",)),
    "gen_cell_d5": ("GenerativePermutoNeuSModelBatched",
                    _cfg(CELL, latent_dim=2), ("bidx",)),
    "dyn_gen_d8": ("DynamicGenerativeNeuSModel", _cfg(), ("bidx", "ts")),
    "style": ("StyleLoTDNeuSModelBatched", STYLE_CFG, ("bidx",)),
}


def _flat_state(model) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(model))}


def _set_state(model, flat) -> None:
    state = nnx.state(model)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(model, state)


def _seeded(name: str, seed: int = 0):
    cls, cfg, _ = MODELS[name]
    jm = getattr(JM, cls)(**cfg)
    rng = np.random.default_rng(seed)
    flat = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in _flat_state(jm).items()}
    for k in flat:
        if k.endswith("bank/flattened_params"):
            flat[k] = rng.uniform(-0.1, 0.1, flat[k].shape).astype(np.float32)
    lat = "autodecoder/latents/weight"
    flat[lat] = rng.normal(0.0, 0.3, flat[lat].shape).astype(np.float32)
    flat["field/var_ctrl/ln_s"] = np.asarray(np.log(64.0) / 10.0, np.float32)
    _set_state(jm, flat)
    return jm, flat


@pytest.fixture(scope="module", params=list(MODELS))
def models(request):
    return (request.param,) + _seeded(request.param)


def _torch_model(name, flat):
    cls, cfg, _ = MODELS[name]
    tm = getattr(TM, cls)(**cfg, device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    return tm


def _rays(n: int, seed: int):
    """examples/train_conditional_dynamic.py's rays, with a few bidx −1."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = rng.uniform(-0.2, 0.2, (n, 3)) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    bidx = rng.integers(0, N_INST, n)
    bidx[:3] = -1
    ts = rng.uniform(-1.0, 1.0, n)
    return {"o": o.astype(np.float32), "d": d.astype(np.float32),
            "bidx": bidx.astype(np.int32), "ts": ts.astype(np.float32)}


def _tested(model, rays, extras, lib):
    rt = model.ray_test(lib(rays["o"]), lib(rays["d"]))
    for k in extras:
        rt[k] = lib(rays[k])
    return rt


def _jax_uniforms(key, r: int, rounds: int = 2):
    """The draws of the batched queries, in their key split order."""
    pk, kc = jax.random.split(key)
    us = [jax.random.uniform(kc, (r, N_COARSE), jnp.float32)]
    for _ in range(rounds):
        pk, ki = jax.random.split(pk)
        us.append(jax.random.uniform(ki, (r, N_IMP), jnp.float32,
                                     minval=CDF_EPS, maxval=1.0 - CDF_EPS))
    return [np.array(u) for u in us]


def _replay(us):
    it = iter(us)

    def draw(shape, lo, hi):
        u = next(it)
        assert tuple(u.shape) == tuple(shape)
        return torch.from_numpy(u)
    return draw


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-1) + 1e-7
    assert float(np.abs(got - want).max()) <= tol, \
        (float(np.abs(got - want).max()), tol)


# ------------------------------------------------- embeddings, latents
def test_embeddings_match_jax():
    from nr3d_lib_tpu.models import embeddings as JE
    from nr3d_lib_tpu_torch.models import embeddings as TE

    rng = np.random.default_rng(1)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    idx = np.asarray([0, 5, 2, 2, -1], np.int32)
    ts = np.asarray([-0.5, 0.0, 0.3, 2.5, 4.99, 5.0, 7.2], np.float32)
    je, te = JE.Embedding(6, 5), TE.Embedding(6, 5, device="cpu")
    js, tsq = JE.SeqEmbedding(6, 5), TE.SeqEmbedding(6, 5, device="cpu")
    for j, t in ((je, te), (js, tsq)):
        j.weight[...] = jnp.asarray(w)
        with torch.no_grad():
            t.weight.copy_(torch.from_numpy(w))
        _close(t.mean_latent().detach().numpy(), j.mean_latent())
    _close(te(torch.from_numpy(idx)).detach().numpy(), je(jnp.asarray(idx)))
    _close(tsq(torch.from_numpy(ts)).detach().numpy(), js(jnp.asarray(ts)))
    jsh = JE.MultiSeqEmbeddingShared(6, 5)
    tsh = TE.MultiSeqEmbeddingShared(6, 5, device="cpu")
    jsh.frame_embedding.weight[...] = jnp.asarray(w)
    tsh.load_state_dict(from_jax_state(_flat_state(jsh)))
    _close(tsh(None, torch.from_numpy(ts)).detach().numpy(),
           jsh(None, jnp.asarray(ts)))
    ji = JE.MultiSeqEmbeddingIndividual(3, 6, 2, 5)
    ti = TE.MultiSeqEmbeddingIndividual(3, 6, 2, 5, device="cpu")
    ti.load_state_dict(from_jax_state(_flat_state(ji)))
    sidx = np.asarray([0, 2, 1, 1, 0, 2, 1], np.int32)
    _close(ti(torch.from_numpy(sidx), torch.from_numpy(ts)).detach().numpy(),
           ji(jnp.asarray(sidx), jnp.asarray(ts)))
    # the port's own init: N(0, std²) from the seed
    e = TE.Embedding(4000, 8, std=0.05, seed=3, device="cpu")
    assert abs(float(e.weight.detach().std()) - 0.05) < 2e-3


def test_autodecoder_matches_jax():
    from nr3d_lib_tpu.models.autodecoder import AutoDecoderMixin as JA
    from nr3d_lib_tpu_torch.models.autodecoder import AutoDecoderMixin as TA

    ja, ta = JA(5, 3, latent_std=0.2), TA(5, 3, latent_std=0.2,
                                          device="cpu")
    ta.load_state_dict(from_jax_state(_flat_state(ja)))
    idx = np.asarray([4, 0, 3], np.int32)
    _close(ta.get_latent(torch.from_numpy(idx)).detach().numpy(),
           ja.get_latent(jnp.asarray(idx)))
    _close(ta.mean_latent().detach().numpy(), ja.mean_latent())
    z = ta.infer_latent_init(torch.Generator().manual_seed(0))
    assert z.shape == (3,) and float(z.abs().max()) < 0.1


# ------------------------------------------------------------ the spaces
def test_batched_spaces_match_jax():
    from nr3d_lib_tpu.models.spatial import batched as JB
    from nr3d_lib_tpu_torch.models.spatial import batched as TB

    rng = np.random.default_rng(2)
    lo = rng.uniform(-1.0, 0.0, (3, 3))
    aabb = np.stack([lo, lo + rng.uniform(0.5, 2.0, (3, 3))], 1
                    ).astype(np.float32)
    ts_range = np.asarray([[0.0, 1.0], [2.0, 4.0], [-1.0, 1.0]], np.float32)
    js = JB.BatchedDynamicSpace(aabb, ts_range=ts_range)
    tsp = TB.BatchedDynamicSpace(aabb, ts_range=ts_range, device="cpu")
    n = 30
    o = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    b = rng.integers(0, 3, n).astype(np.int32)
    ts = rng.uniform(-1.0, 4.0, n).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    rt, rj = tsp.ray_test(T(o), T(d), T(b)), js.ray_test(J(o), J(d), J(b))
    np.testing.assert_array_equal(rt["mask"].numpy(), np.asarray(rj["mask"]))
    for k in ("near", "far"):
        _close(rt[k].numpy(), rj[k])
    for got, want in zip(tsp.normalize_rays(T(o), T(d), T(b)),
                         js.normalize_rays(J(o), J(d), J(b))):
        _close(got.numpy(), want)
    _close(tsp.normalize_coords(T(o), T(b)).numpy(),
           js.normalize_coords(J(o), J(b)))
    _close(tsp.unnormalize_coords(T(o), T(b)).numpy(),
           js.unnormalize_coords(J(o), J(b)))
    b[0] = -1
    _close(tsp.normalize_ts(T(ts), T(b)).numpy(), js.normalize_ts(J(ts), J(b)))
    _close(tsp.unnormalize_ts(T(ts), T(b)).numpy(),
           js.unnormalize_ts(J(ts), J(b)))
    all_ts = rng.uniform(0.0, 5.0, (3, 6)).astype(np.float32)
    for got, want in zip(TB.BatchedDynamicSpace.normalize_all_ts_keyframes(
            T(all_ts)), JB.BatchedDynamicSpace.normalize_all_ts_keyframes(
            J(all_ts))):
        _close(got.numpy(), want)
    x, bb, tt = tsp.sample_pts_uniform(torch.Generator().manual_seed(0), 7)
    assert x.shape == (3, 7, 3) and bb.shape == tt.shape == (3, 7)
    assert torch.equal(bb[:, 0], torch.arange(3))
    assert TB.BatchedBlockSpace(n_batch=2, device="cpu").aabb.tolist() == \
        [[[-1.0] * 3, [1.0] * 3]] * 2


# ------------------------------------------------------------- the fields
@pytest.mark.parametrize("name", ["gen_d7", "gen_cell_d5"])
def test_generative_field_matches_jax(name):
    """`forward_sdf` and `forward_sdf_nablas` of the generative SDF: the
    classic lattice by autograd, the cell layout by the decoder's vjp plus
    the bank's nablas."""
    jm, flat = _seeded(name, seed=3)
    tm = _torch_model(name, flat)
    js, ts_ = jm.field.implicit_surface, tm.field.implicit_surface
    assert ts_.bank.backend == ("cell" if "cell" in name else "xla")
    assert ts_.bank.meta.n_dims == (5 if "cell" in name else 7)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.0, 1.0, (200, 3)).astype(np.float32)
    z = rng.normal(0.0, 0.5, (200, ts_.z_dim)).astype(np.float32)
    graphdef, state = nnx.split(js)
    oj = jax.jit(lambda st: nnx.merge(graphdef, st).forward_sdf_nablas(
        jnp.asarray(x), jnp.asarray(z)))(state)
    ot = ts_.forward_sdf_nablas(torch.from_numpy(x), torch.from_numpy(z))
    for k in ("sdf", "h", "nablas"):
        _close(ot[k].detach().numpy(), oj[k])
    _close(ts_.forward_sdf(torch.from_numpy(x), torch.from_numpy(z))["sdf"]
           .detach().numpy(), js.forward_sdf(jnp.asarray(x),
                                             jnp.asarray(z))["sdf"])


def test_cell_backend_refuses_more_than_five_dims():
    from nr3d_lib_tpu_torch.models.fields_conditional import \
        GenerativePermutoConcatSDF

    with pytest.raises(ValueError, match=r"\[2, 5\]"):
        GenerativePermutoConcatSDF(4, permuto_cfg={"backend": "cell"},
                                   device="cpu")


# ------------------------------------------------------------ the renders
def _jax_render(jm, rays, extras, key=None):
    graphdef, state = nnx.split(jm)

    @jax.jit
    def render(st, k):
        m = nnx.merge(graphdef, st)
        return m.ray_query(_tested(m, rays, extras, jnp.asarray), key=k)

    return render(state, key)


def test_render_matches_jax_ray_by_ray(models):
    name, jm, flat = models
    tm = _torch_model(name, flat)
    extras = MODELS[name][2]
    rays = _rays(N_RAYS, 5)
    # unperturbed once (the samplers' midpoints and fixed quantiles are
    # the models' shared query code), perturbed for every model
    keys = (None, jax.random.key(6)) if name == "gen_d7" else \
        (jax.random.key(6),)
    for key in keys:
        rj, vbj = _jax_render(jm, rays, extras, key)
        draw = None if key is None else \
            _replay(_jax_uniforms(key, N_RAYS))
        with torch.no_grad():
            rt, vbt = tm.ray_query(_tested(tm, rays, extras,
                                           torch.from_numpy), draw=draw)
        assert set(rt) == set(rj) and set(vbt) == set(vbj)
        assert vbt["nablas"].shape == (N_RAYS, N_COARSE + 2 * N_IMP, 3)
        for k, v in rt.items():
            assert torch.isfinite(v).all(), k
        assert float(rt["mask_volume"].mean()) > 0.1
        assert float(rt["mask_volume"][:3].abs().max()) == 0.0   # bidx −1
        err = np.zeros(N_RAYS)
        for k in ("rgb_volume", "depth_volume", "mask_volume"):
            e = np.abs(rt[k].numpy() - np.asarray(rj[k])).reshape(N_RAYS, -1)
            err = np.maximum(err, e.max(-1))
        assert (err <= 1e-4).mean() >= 0.99, err.max()
        np.testing.assert_allclose(vbt["t"].numpy(), np.asarray(vbj["t"]),
                                   rtol=0, atol=1e-5)


def test_the_latent_conditions_the_render(models):
    name, _, flat = models
    tm = _torch_model(name, flat)
    extras = MODELS[name][2]
    rays = _rays(N_RAYS, 7)
    rays2 = dict(rays, bidx=np.where(rays["bidx"] >= 0,
                                     (rays["bidx"] + 1) % N_INST, -1
                                     ).astype(np.int32))
    with torch.no_grad():
        r1, _ = tm.ray_query(_tested(tm, rays, extras, torch.from_numpy))
        r2, _ = tm.ray_query(_tested(tm, rays2, extras, torch.from_numpy))
    assert not torch.allclose(r1["rgb_volume"], r2["rgb_volume"])


# --------------------------------------------------------------- the step
def _loss_of(rendered, vb, z, gt, lib):
    """examples/train_generative_shapes.py:116-121 with target |d|."""
    norm = lib.linalg.norm(vb["nablas"], axis=-1) if lib is jnp else \
        torch.linalg.norm(vb["nablas"], dim=-1)
    return (lib.mean((rendered["rgb_volume"] - gt) ** 2)
            + 0.03 * lib.mean((norm - 1.0) ** 2) + 1e-4 * lib.mean(z ** 2))


def test_train_step_matches_jax(models):
    name, jm, flat = models
    tm = _torch_model(name, flat)
    extras = MODELS[name][2]
    rays = _rays(N_RAYS, 8)
    key = jax.random.key(9)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)
    gt = np.abs(rays["d"])

    def loss_fn(p):
        m = nnx.merge(graphdef, p, rest)
        rendered, vb = m.ray_query(_tested(m, rays, extras, jnp.asarray),
                                   key=key)
        z = m.autodecoder.get_latent(jnp.arange(N_INST))
        return _loss_of(rendered, vb, z, jnp.asarray(gt), jnp)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    jg = {"/".join(str(p) for p in k): np.asarray(v[...])
          for k, v in nnx.to_flat_state(jg)}
    rendered, vb = tm.ray_query(_tested(tm, rays, extras, torch.from_numpy),
                                draw=_replay(_jax_uniforms(key, N_RAYS)))
    tl = _loss_of(rendered, vb, tm._latents(), torch.from_numpy(gt), torch)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(jg)
    errs = {k: float(np.linalg.norm(got[k] - jg[k]) /
                     max(np.linalg.norm(jg[k]), 1e-12)) for k in got}
    assert max(errs.values()) <= 1e-2, errs
    assert float(np.abs(got["autodecoder/latents/weight"]).max()) > 0


def test_port_step_loss_falls():
    """Eight steps of the port (global norm clipped to 5, Adam(3e-3), the
    examples' lifecycle): the loss falls."""
    from nr3d_lib_tpu_torch.models.utils import clip_by_global_norm_

    _, flat = _seeded("dyn_gen_d8", seed=10)
    tm = _torch_model("dyn_gen_d8", flat)
    opt = torch.optim.Adam(tm.parameters(), lr=3e-3)
    rays = _rays(N_RAYS, 11)
    g = torch.Generator().manual_seed(0)
    gt = torch.from_numpy(np.abs(rays["d"]))
    losses = []
    for it in range(8):
        tm.training_before_per_step(it, g)
        opt.zero_grad()
        rendered, vb = tm.ray_query(_tested(tm, rays, ("bidx", "ts"),
                                            torch.from_numpy), generator=g)
        loss = _loss_of(rendered, vb, tm._latents(), gt, torch)
        loss.backward()
        clip_by_global_norm_(tm.parameters(), 5.0)
        opt.step()
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0], losses
    assert tm.lifecycle_update_every == 1


@pytest.mark.parametrize("name", list(MODELS))
def test_entry_points_default_to_cuda(name):
    cls, cfg, _ = MODELS[name]
    if torch.cuda.is_available():
        assert getattr(TM, cls)(**cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(TM, cls)(**cfg)


# ------------------------------------- modulations, importance sampling
@pytest.mark.parametrize("per_point", [False, True], ids=["per_row",
                                                          "per_point"])
def test_film_siren_matches_jax(per_point):
    from nr3d_lib_tpu.models.modulations import FiLMSiren as JF
    from nr3d_lib_tpu_torch.models.modulations import FiLMSiren as TF

    jf = JF(3, 4, 6, D=3, W=32, seed=2)
    tf = TF(3, 4, 6, D=3, W=32, device="cpu")
    tf.load_state_dict(from_jax_state(_flat_state(jf)))
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (5, 30, 3)).astype(np.float32)
    z = rng.normal(size=(5, 30, 6) if per_point else (5, 6)
                   ).astype(np.float32)
    graphdef, state = nnx.split(jf)
    yj = jax.jit(lambda st: nnx.merge(graphdef, st)(jnp.asarray(x),
                                                    jnp.asarray(z)))(state)
    with torch.no_grad():
        yt = tf(torch.from_numpy(x), torch.from_numpy(z))
    assert yt.shape == (5, 30, 4)
    _close(yt.numpy(), yj, rel=1e-4)     # sin(30·…) amplifies rounding


def test_importance_sampler_matches_jax():
    from nr3d_lib_tpu.models.importance import ErrorMap as JE
    from nr3d_lib_tpu.models.importance import ImpSampler as JS
    from nr3d_lib_tpu_torch.models.importance import ErrorMap as TE
    from nr3d_lib_tpu_torch.models.importance import ImpSampler as TS

    rng = np.random.default_rng(13)
    with jax.enable_x64(False):
        je = JE(3, (16, 24), ema=0.8)
        te = TE(3, (16, 24), ema=0.8, device="cpu")
        cells = rng.permutation(16 * 24)[:200]          # distinct pixels
        xy = np.stack([(cells % 24 + rng.uniform(size=200)) / 24,
                       (cells // 24 + rng.uniform(size=200)) / 16], -1
                      ).astype(np.float32)
        err = rng.uniform(0, 5, 200).astype(np.float32)
        je.collect(1, jnp.asarray(xy), jnp.asarray(err))
        te.collect(1, torch.from_numpy(xy), torch.from_numpy(err))
        _close(te.error_map.numpy(), je.error_map[...])
        for a, b in zip(te.construct_cdf(), je.construct_cdf()):
            _close(a.numpy(), b)
        key, n = jax.random.key(14), 300
        k1, k2, k3, k4 = jax.random.split(key, 4)
        us = [np.array(jax.random.uniform(k, shape)) for k, shape in
              ((k1, (n,)), (k2, (n,)), (k3, (n, 2)), (k4, (n, 2)))]
        xj = JS(je, 0.25).sample_pixel(key, n, 1)
    it = iter(us)
    xt = TS(te, 0.25).sample_pixel(
        n, 1, draw=lambda shape, lo, hi: torch.from_numpy(next(it)))
    _close(xt.numpy(), xj)
    assert float(xt.min()) >= 0.0 and float(xt.max()) <= 1.0
