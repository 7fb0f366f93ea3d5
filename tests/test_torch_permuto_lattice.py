"""Port parity: the classic permutohedral lattice and what is built on it
(`nr3d_lib_tpu_torch/ops/permuto.py`, `PermutoParams(backend="xla")`,
`PermutoEncoding`, `permuto/mll.py`, `grid_encodings/utils.py`,
`models/annealers.py`, the permuto fields on their default backend and
`DynamicPermutoNeuSModel` at its default field) against the JAX package
on the CPU.

The JAX package computes this lattice in XLA (no Pallas kernel); the port
in plain PyTorch on any device. Inputs are float32 from numpy seeds and
include lattice ties (points on a 1/8 grid, x = 0.5, equal coordinates,
the box corners). The simplex search is held against eager JAX, op by op
(under `jax.jit` XLA's CPU compiler contracts the elevation into an FMA);
whole fields and models against jitted JAX, where that FMA can move a
point across a simplex face (none does on these seeds).

Tolerances: the simplex keys and the hash indices must be equal, the
barycentric weights within 1e-6; values, dy/dx, gradients and second
order are float32 sums in another order, within 1e-5 relative to the
largest entry (the MLL's outputs within 1e-4: its second lattice
encodes the first one's rounded outputs at scales up to 32), the fields'
and the MLL's gradients by parameter path within 1e-4 relative L2. The dynamic model's render: every ray within
1e-5 (it makes no budget cut), and one step's loss within 1e-5 relative
and every gradient within 1e-4 relative L2, the standard of
`test_torch_dynamic_neus.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.ops import permuto as jperm
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.ops import _build
from nr3d_lib_tpu_torch.ops import permuto as tperm

torch.set_num_threads(1)

N = 800


def _points(d: int, seed: int, n: int = N, lo: float = 0.0,
            hi: float = 1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (n, d)).astype(np.float32)
    x[:64] = np.round(x[:64] * 8.0) / 8.0               # lattice ties
    x[64] = 0.5 * (lo + hi)
    x[65:70] = x[65:70, :1]                             # equal coordinates
    x[70], x[71] = lo, hi                               # the box corners
    return x


def _close(got, want, rel: float = 1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _flat(state) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(state)}


def _set_state(jm, flat):
    state = nnx.state(jm)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(jm, state)


def _grad_errs(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    return {k: float(np.linalg.norm(got[k] - want[k]) /
                     max(np.linalg.norm(want[k]), 1e-12)) for k in got}


# ----------------------------------------------------- the lattice math
@pytest.mark.parametrize("d", [3, 4, 7])
def test_simplex_and_hash_bitwise_match_eager_jax(d):
    x = _points(d, d) * np.float32(9.0)
    kj, bj = jperm._simplex(jnp.asarray(x), d)
    kt, bt = tperm._simplex(torch.from_numpy(x), d)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(bt.sum(-1).numpy(), 1.0, atol=1e-5)
    assert (kt < 0).any()          # negative keys wrap as uint32
    for size in (2 ** 10, 2 ** 17):
        np.testing.assert_array_equal(
            tperm._hash_keys(kt, size).numpy(),
            np.asarray(jperm._hash_keys(kj, size)))


def test_meta_matches_jax():
    for args in ((3, [2.0, 8.0, 24.0], 2, 10), (4, [[1, 2, 3, 4.0]], 4, 17)):
        jm, tm = jperm.make_permuto_meta(*args), tperm.make_permuto_meta(*args)
        for k in ("n_dims", "level_scales", "level_n_feats", "hashmap_sizes",
                  "n_levels", "level_n_params", "level_offsets", "n_params",
                  "out_features"):
            assert getattr(tm, k) == getattr(jm, k), k


LATTICE = (3, [2.0, 8.0, 24.0, 64.0], 2, 8)      # 256-entry hashes collide


def _lattice_inputs(meta, seed: int):
    rng = np.random.default_rng(seed)
    x = _points(meta.n_dims, seed)
    p = rng.uniform(-0.1, 0.1, meta.n_params).astype(np.float32)
    g = rng.standard_normal((N, meta.out_features)).astype(np.float32)
    return x, p, g


@pytest.mark.parametrize("kw", [{}, {"max_level": 1},
                                {"level_weights": [1.0, 0.7, 0.2, 0.0]}],
                         ids=["plain", "max_level", "weights"])
def test_encode_values_grads_second_order_match_jax(kw):
    jm, tm = jperm.make_permuto_meta(*LATTICE), \
        tperm.make_permuto_meta(*LATTICE)
    x, p, g = _lattice_inputs(tm, 1)
    jkw = {k: jnp.asarray(v, jnp.float32) if k == "level_weights" else v
           for k, v in kw.items()}
    tkw = {k: torch.tensor(v) if k == "level_weights" else v
           for k, v in kw.items()}

    def jf(a, b):
        return jperm.permuto_encode(a, b, jm, **jkw)

    yj = jf(jnp.asarray(x), jnp.asarray(p))
    _, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(p))
    dxj, dpj = vjp(jnp.asarray(g))
    # second order: d/d(x, p) of Σ (dL/dx)² through the vjp
    j2x, j2p = jax.grad(lambda a, b: jnp.sum(jax.vjp(
        jf, a, b)[1](jnp.asarray(g))[0] ** 2), (0, 1))(jnp.asarray(x),
                                                       jnp.asarray(p))

    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(p).requires_grad_(True)
    yt = tperm.permuto_encode(xt, pt, tm, **tkw)
    _close(yt, yj)
    dxt, dpt = torch.autograd.grad(yt, (xt, pt), torch.from_numpy(g),
                                   create_graph=True)
    _close(dxt, dxj)
    _close(dpt, dpj)
    # the barycentric weights are affine in x inside a simplex: dL/dx
    # does not depend on x (autograd finds no path; JAX gives zeros)
    t2x, t2p = torch.autograd.grad((dxt ** 2).sum(), (xt, pt),
                                   allow_unused=True)
    assert t2x is None and float(jnp.abs(j2x).max()) == 0.0
    _close(t2p, j2p)
    if "max_level" in kw:
        assert float(yt[:, 4:].abs().max()) == 0.0


def test_fwd_dydx_and_bwd_dydx_match_jax():
    jm, tm = jperm.make_permuto_meta(*LATTICE), \
        tperm.make_permuto_meta(*LATTICE)
    x, p, g = _lattice_inputs(tm, 2)
    yj, dj = jperm.permuto_enc_fwd_dydx(jnp.asarray(x), jnp.asarray(p), jm)
    yt, dt = tperm.permuto_enc_fwd_dydx(torch.from_numpy(x),
                                        torch.from_numpy(p), tm)
    assert dt.shape == (N, tm.out_features, 3)
    _close(yt, yj)
    _close(dt, dj)
    _close(tperm.permuto_enc_bwd_dydx(torch.from_numpy(g), dt),
           jperm.permuto_enc_bwd_dydx(jnp.asarray(g), dj))


# ------------------------------------------------------ the annealers
def test_annealers_match_jax():
    from nr3d_lib_tpu.models import annealers as J
    from nr3d_lib_tpu_torch.models import annealers as T

    cfgs = [dict(type="constant", value=0.3),
            dict(type="linear", start_val=0.1, stop_val=2.0, start_it=10,
                 stop_it=50),
            dict(type="logspace", start_val=0.1, stop_val=64.0, stop_it=40),
            dict(type="milestones", milestones=[5, 20], vals=[1, 2, 3])]
    for cfg in cfgs:
        ja, ta = J.get_annealer(**cfg), T.get_annealer(**cfg)
        for it in (0, 5, 12, 20, 33, 50, 99):
            assert ta(it) == ja(it), (cfg, it)
            assert T.get_anneal_val(it, **cfg) == J.get_anneal_val(it, **cfg)
    for typ in ("hardmask", "cosine"):
        ja = J.MultiresAnnealer(5, stop_it=40, start_it=4, start_level=1,
                                type=typ)
        ta = T.MultiresAnnealer(5, stop_it=40, start_it=4, start_level=1,
                                type=typ)
        for it in (0, 10, 25, 40, 60):
            (jl, jw), (tl, tw) = ja(it), ta(it)
            assert jl == tl
            if jw is None:
                assert tw is None
            else:
                np.testing.assert_array_equal(tw, jw)


# --------------------------------------------------- PermutoEncoding
ENC_KW = dict(coarsest_res=4.0, finest_res=64.0, n_levels=4, n_feats=2,
              log2_hashmap_size=10, seed=1)


@pytest.mark.parametrize("anneal", [None, "hardmask", "cosine"])
def test_permuto_encoding_matches_jax(anneal):
    from nr3d_lib_tpu.models.grid_encodings.permuto import \
        PermutoEncoding as JEnc
    from nr3d_lib_tpu_torch.models.grid_encodings import \
        PermutoEncoding as TEnc

    acfg = None if anneal is None else {"stop_it": 100, "type": anneal}
    je, te = JEnc(3, anneal_cfg=acfg, **ENC_KW), \
        TEnc(3, anneal_cfg=acfg, **ENC_KW, device="cpu")
    assert te.meta == tperm.make_permuto_meta(3, list(je.meta.level_scales),
                                              2, 10)
    p = np.random.default_rng(3).uniform(-0.1, 0.1, je.meta.n_params
                                         ).astype(np.float32)
    je.flattened_params[...] = jnp.asarray(p)
    te.load_state_dict(from_jax_state({"flattened_params": p}))
    assert (te.annealer is None) == (anneal is None)
    te.set_anneal_iter(55)
    if anneal == "cosine":
        # JAX's module cannot hold its window (flax nnx refuses the array
        # on a static attribute: ROADMAP.md §C); its pieces give the same
        ml, w = je.annealer(55)
        je.max_level, je.level_weights = ml, nnx.data(jnp.asarray(w))
        np.testing.assert_array_equal(te.level_weights.numpy(), w)
    else:
        je.set_anneal_iter(55)
    assert te.max_level == je.max_level
    x = _points(3, 4, lo=-1.0)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(te(xt), je(xj))
    _close(te(xt, max_level=2), je(xj, max_level=2))
    yj, dj = je.forward_dydx(xj)
    yt, dt = te.forward_dydx(xt)
    _close(yt, yj)
    _close(dt, dj)
    g = np.random.default_rng(5).standard_normal(yt.shape).astype(np.float32)
    _close(te.backward_dydx(torch.from_numpy(g), dt, xt),
           je.backward_dydx(jnp.asarray(g), dj, xj))
    if anneal == "hardmask":
        assert te.max_level == 2 and float(te(xt)[:, 6:].abs().max()) == 0.0
    if anneal == "cosine":
        assert te.level_weights is not None
        assert float(te.level_weights[-1]) < 1.0


# --------------------------------------------------------------- MLL
MLL_KW = dict(D=2, lattice_n_levels=3,
              lattice_cfg={"log2_hashmap_size": 9, "coarsest_res": 4.0,
                           "finest_res": 32.0})


@pytest.mark.parametrize("use_residual", [False, True],
                         ids=["plain", "residual"])
def test_mllnet_matches_jax(use_residual):
    """MLLNet's output, `forward_with_nablas`, and a loss over both
    (second order through the chained lattices) by parameter path."""
    from nr3d_lib_tpu.models.grid_encodings.permuto.mll import MLLNet as JNet
    from nr3d_lib_tpu_torch.models.grid_encodings.permuto.mll import \
        MLLNet as TNet

    jn = JNet(3, 2, use_residual=use_residual, **MLL_KW, seed=3)
    flat = _flat(nnx.state(jn))
    rng = np.random.default_rng(6)
    for k in flat:
        if k.endswith("flattened_params"):
            flat[k] = rng.uniform(-0.1, 0.1, flat[k].shape).astype(np.float32)
        if k.endswith("/zero"):
            flat[k] = np.asarray(0.3, np.float32)
    _set_state(jn, flat)
    tn = TNet(3, 2, use_residual=use_residual, **MLL_KW, seed=3,
              device="cpu")
    tn.load_state_dict(from_jax_state(flat))
    assert any(k.endswith("zero") for k in flat) == use_residual
    x = _points(3, 7, n=300, lo=-1.0)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    oj = jn.forward_with_nablas(xj, max_out_dims=1)
    with torch.no_grad():
        ot = tn.forward_with_nablas(xt, max_out_dims=1)
    for k in ("output", "h", "nablas"):     # chained lattices: see below
        _close(ot[k], oj[k], 1e-4)
    assert float(np.abs(np.asarray(oj["nablas"])).max()) > 1e-3

    graphdef, params, rest = nnx.split(jn, nnx.Param, ...)

    def jloss(pp):
        r = nnx.merge(graphdef, pp, rest).forward_with_nablas(
            xj, max_out_dims=1)
        return jnp.mean(r["output"] ** 2) + jnp.mean(r["nablas"] ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    r = tn.forward_with_nablas(xt, max_out_dims=1)
    tl = torch.mean(r["output"] ** 2) + torch.mean(r["nablas"] ** 2)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    errs = _grad_errs(to_jax_paths({k: p.grad
                                    for k, p in tn.named_parameters()}),
                      _flat(jg))
    assert max(errs.values()) <= 1e-4, errs
    stats = tn.stat_param("net")
    want = jn.stat_param("net")
    assert set(stats) == set(want)
    for k in want:
        assert abs(stats[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), k


# ------------------------------------------------------------ utils
def test_grid_utils_match_jax():
    from nr3d_lib_tpu.models.grid_encodings import utils as J
    from nr3d_lib_tpu_torch.models.grid_encodings import utils as T

    rng = np.random.default_rng(8)
    grid = rng.standard_normal((5, 6, 7, 3)).astype(np.float32)
    x = _points(3, 9, lo=-1.0)
    _close(T.trilinear_interp(torch.from_numpy(grid), torch.from_numpy(x)),
           J.trilinear_interp(jnp.asarray(grid), jnp.asarray(x)))
    line = rng.standard_normal((9, 4)).astype(np.float32)
    t = np.concatenate([rng.uniform(-1, 1, 200), [-1.0, 1.0, 0.0]]
                       ).astype(np.float32)
    _close(T.gridsample1d(torch.from_numpy(line), torch.from_numpy(t)),
           J.gridsample1d(jnp.asarray(line), jnp.asarray(t)))
    h = rng.standard_normal((50, 8)).astype(np.float32)
    for reduce, sel in (("concat", 3), ("sum", None)):
        jdec, jmlp = J.get_multires_decoder([2, 2, 2, 2], 5, reduce=reduce,
                                            select_n_levels=sel, W=16)
        tdec, tmlp = T.get_multires_decoder([2, 2, 2, 2], 5, reduce=reduce,
                                            select_n_levels=sel, W=16)
        tmlp.load_state_dict(from_jax_state(_flat(nnx.state(jmlp))))
        with torch.no_grad():
            _close(tdec(torch.from_numpy(h)), jdec(jnp.asarray(h)))
    with pytest.raises(ValueError):
        T.get_multires_decoder([2, 4], 5, reduce="sum")


# ----------------------------------------- the fields, classic lattice
PERMUTO = {"res_list": [2.0, 8.0, 24.0], "log2_hashmap_size": 8}
SDF_CFG = dict(permuto_cfg=PERMUTO, decoder_cfg={"D": 1, "W": 16},
               radius_init=0.5)


def _field_classes():
    from nr3d_lib_tpu.models.fields.nerf import PermutoNeRF as JNeRF
    from nr3d_lib_tpu.models.fields.neus import PermutoNeuS as JNeuS
    from nr3d_lib_tpu.models.fields.sdf import PermutoSDF as JSDF
    from nr3d_lib_tpu_torch.models.fields.nerf import PermutoNeRF as TNeRF
    from nr3d_lib_tpu_torch.models.fields.neus import PermutoNeuS as TNeuS
    from nr3d_lib_tpu_torch.models.fields.sdf import PermutoSDF as TSDF

    return {"sdf": (JSDF, TSDF, SDF_CFG),
            "neus": (JNeuS, TNeuS, dict(surface_cfg=SDF_CFG,
                                        radiance_cfg={"D": 2, "W": 16})),
            "nerf": (JNeRF, TNeRF, dict(permuto_cfg=PERMUTO,
                                        density_decoder_cfg={"D": 1,
                                                             "W": 16},
                                        radiance_cfg={"D": 2, "W": 16}))}


@pytest.fixture(scope="module", params=["nerf", "neus", "sdf"])
def fields(request):
    jcls, tcls, cfg = _field_classes()[request.param]
    jf = jcls(**cfg)
    flat = _flat(nnx.state(jf))
    key = next(k for k in flat if k.endswith("bank/flattened_params"))
    flat[key] = np.random.default_rng(0).uniform(
        -0.1, 0.1, flat[key].shape).astype(np.float32)
    _set_state(jf, flat)
    tf = tcls(**cfg, device="cpu")
    tf.load_state_dict(from_jax_state(flat))
    bank = tf.implicit_surface.bank if request.param == "neus" else tf.bank
    assert bank.backend == "xla"
    assert bank.flattened_params.shape == (3 * 2 ** 8 * 2,)
    return request.param, jf, tf


def _field_out(f, name, x, v, lib):
    if name == "sdf":
        return {**f.forward_sdf_nablas(lib(x)), "sdf_only": f(lib(x))}
    return f(lib(x), lib(v))


def _field_loss(out, name, lib, inv_s=None):
    if name == "nerf":
        return lib.mean(out["sigma"]) + lib.mean(out["rgb"] ** 2)
    nrm = jnp.linalg.norm(out["nablas"], axis=-1) if lib is jnp else \
        torch.linalg.norm(out["nablas"], dim=-1)
    loss = lib.mean(out["sdf"] ** 2) + 0.1 * lib.mean((nrm - 1.0) ** 2)
    if name == "neus":
        loss = loss + lib.mean(out["rgb"] ** 2) + 1e-3 * inv_s
    return loss


def test_classic_fields_match_jax(fields):
    """Outputs (the autograd nablas) and a loss's gradients by parameter
    path: for the SDF and NeuS an eikonal term whose gradients run
    through the nablas' second order; the CPU route launches no kernel."""
    name, jf, tf = fields
    rng = np.random.default_rng(10)
    x = _points(3, 11, n=400, lo=-1.0)
    x[64] = 0.25            # not the origin, where |x|'s gradient is NaN
    v = rng.normal(size=(400, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    want = _field_out(jf, name, x, v, jnp.asarray)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        got = _field_out(tf, name, x, v, torch.from_numpy)
    assert set(got) == set(want)
    for k in want:
        assert not got[k].requires_grad
        _close(got[k], want[k])

    graphdef, params, rest = nnx.split(jf, nnx.Param, ...)

    def jloss(pp):
        m = nnx.merge(graphdef, pp, rest)
        return _field_loss(_field_out(m, name, x, v, jnp.asarray), name, jnp,
                           m.forward_inv_s() if name == "neus" else None)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    tf.zero_grad(set_to_none=True)
    tl = _field_loss(_field_out(tf, name, x, v, torch.from_numpy), name,
                     torch, tf.forward_inv_s() if name == "neus" else None)
    tl.backward()
    assert dict(_build.LAUNCHES) == before
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    errs = _grad_errs(to_jax_paths({k: p.grad
                                    for k, p in tf.named_parameters()}),
                      _flat(jg))
    assert max(errs.values()) <= 1e-4, errs
    key = next(k for k in errs if k.endswith("bank/flattened_params"))
    assert float(next(p.grad for k, p in tf.named_parameters()
                      if k.endswith("bank.flattened_params")).abs().max()) > 0
    assert errs[key] <= 1e-4
    if name != "nerf":
        with pytest.raises(ValueError, match="cell backends"):
            (tf.implicit_surface if name == "neus" else tf).bank.nablas(
                torch.ones(2, 6), torch.rand(2, 3))


# -------------------------------- DynamicPermutoNeuSModel, its default
N_RAYS = 32


@pytest.fixture(scope="module")
def dyn():
    """The model at its default field (the classic 4D lattice, res [8 …
    128], 2^17 entries a level), a small accel; weights bridged, the
    table ±0.1, ln_s = ln(64)/10. The suite's x64 makes the accel's
    keyframes float64 on the JAX side: they are set to their float32
    values on both sides (the production dtype)."""
    from nr3d_lib_tpu.models.model_families import \
        DynamicPermutoNeuSModel as JModel
    from nr3d_lib_tpu_torch.models.model_families import \
        DynamicPermutoNeuSModel as TModel

    cfg = dict(accel_cfg={"resolution": 8}, n_time_keys=4)
    jm = JModel(**cfg)
    flat = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in _flat(nnx.state(jm)).items()}
    key = "field/implicit_surface/bank/flattened_params"
    assert flat[key].shape == (5 * 2 ** 17 * 2,)
    flat[key] = np.random.default_rng(0).uniform(
        -0.1, 0.1, flat[key].shape).astype(np.float32)
    flat["field/var_ctrl/ln_s"] = np.asarray(np.log(64.0) / 10.0, np.float32)
    _set_state(jm, flat)
    tm = TModel(**cfg, device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    assert tm.field.implicit_surface.bank.backend == "xla"
    return jm, tm


def _dyn_rays(seed: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(N_RAYS, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(N_RAYS, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ts = rng.uniform(-1.0, 1.0, N_RAYS)
    return o.astype(np.float32), d.astype(np.float32), ts.astype(np.float32)


def _dyn_tested(m, o, d, ts, lib):
    rt = m.ray_test(lib(o), lib(d))
    rt["ts"] = lib(ts)
    return rt


def _dyn_uniforms(key, n_coarse: int = 64, n_imp: int = 16,
                  rounds: int = 2):
    """The default dynamic query's draws in its key split order."""
    pk, kc = jax.random.split(key)
    us = [jax.random.uniform(kc, (N_RAYS, n_coarse), jnp.float32)]
    for _ in range(rounds):
        pk, ki = jax.random.split(pk)
        us.append(jax.random.uniform(ki, (N_RAYS, n_imp), jnp.float32,
                                     minval=1e-8, maxval=1.0 - 1e-8))
    return [np.array(u) for u in us]


def test_dynamic_default_render_and_step_match_jax(dyn):
    from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss

    jm, tm = dyn
    o, d, ts = _dyn_rays(12)
    graphdef, state = nnx.split(jm)

    @jax.jit
    def render(st, oo, dd, tt):
        m = nnx.merge(graphdef, st)
        return m.ray_query(_dyn_tested(m, oo, dd, tt, jnp.asarray))[0]

    rj = render(state, o, d, ts)
    with torch.no_grad():
        rt, vb = tm.ray_query(_dyn_tested(tm, o, d, ts, torch.from_numpy))
    assert vb["t"].shape == (N_RAYS, 64 + 2 * 16)
    assert float(rt["mask_volume"].mean()) > 0.1
    for k in ("rgb_volume", "depth_volume", "mask_volume"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), rtol=0,
                                   atol=1e-5, err_msg=k)

    key = jax.random.key(13)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p, oo, dd, tt):
        m = nnx.merge(graphdef, p, rest)
        rendered, vbj = m.ray_query(_dyn_tested(m, oo, dd, tt, jnp.asarray),
                                    key=key)
        nrm = jnp.linalg.norm(vbj["nablas"], axis=-1)
        return jnp.mean((rendered["rgb_volume"] - jnp.abs(dd)) ** 2) + \
            0.1 * jnp.mean((nrm - 1.0) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params, o, d, ts)
    tm.zero_grad(set_to_none=True)
    rendered, vb = tm.ray_query(_dyn_tested(tm, o, d, ts, torch.from_numpy),
                                draw=_replay(_dyn_uniforms(key)))
    tl = torch.mean((rendered["rgb_volume"] - torch.abs(
        torch.from_numpy(d))) ** 2) + 0.1 * eikonal_loss(vb["nablas"])
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    errs = _grad_errs(to_jax_paths({k: p.grad
                                    for k, p in tm.named_parameters()}),
                      _flat(jg))
    assert max(errs.values()) <= 1e-4, errs
    tm.zero_grad(set_to_none=True)


def _replay(us):
    it = iter(us)

    def draw(shape, lo, hi):
        u = next(it)
        assert tuple(u.shape) == tuple(shape)
        return torch.from_numpy(u)
    return draw
