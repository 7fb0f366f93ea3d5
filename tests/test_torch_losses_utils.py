"""Port parity: the compositing helpers, losses and training utilities of
ROADMAP A19 against the JAX package on the CPU.

* `graphics/nerf.py` `ray_tau_to_vw`, `ray_composite`; `graphics/neus.py`
  `neus_ray_sdf_to_vw`, `neus_packed_sdf_to_vw`,
  `neus_estimate_sdf_nablas_to_alpha`; `graphics/raytest.py`
  `ray_sphere_intersection` (hits, misses, a start inside, a centre).
* `models/loss`: the regularizers, `reduce` and the six reconstruction
  losses (masked and not, every reduction), `get_recon_loss`, the two
  safe losses' custom backwards against `jax.grad` (past the clip
  included), `ssim` (map and mean, [H, W] and [H, W, C], and its
  gradient), the GEM losses and `clip_loss` (raises in both).
* `models/utils.py`: every `get_scheduler` type at steps 0..20 against
  the optax schedule; 5 steps of every `get_optimizer` type × every
  scheduler type (and Adam with `clip_grad_norm`) against optax on the
  same gradients; `batchify_query`, `calc_grad_norm` (L2 and inf) and
  `clip_grad_norm`.
* The public names: every module of the JAX package (walked with
  `ast`) has its counterpart at the same path in the port, with every
  name of its `__all__` (or, without one, every public top-level
  function and class; `utils`' three JAX names renamed to torch ones);
  the A7c classes have JAX's methods;
  the names outside an `__all__` that A14 ports (the cameras' path and
  interpolation helpers, `fisheye_undistort`, `maths`' package exports,
  `brick4_encode_frozen_x`) exist in both.

Inputs are float32 from a numpy seed (the conftest turns on x64 for
JAX: every JAX input is float32). Tolerances: values within 1e-6 of the
largest entry (1e-5 for SSIM, whose terms are differences of filtered
squares), gradients within 1e-5 relative L2, the ray–sphere hit flags
exact; schedules within 1e-6 relative; parameters after each optimizer
step within 1e-6 of their scale (float32 updates in another order).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nr3d_lib_tpu.graphics import nerf as jnerf
from nr3d_lib_tpu.graphics import neus as jneus
from nr3d_lib_tpu.graphics import raytest as jraytest
from nr3d_lib_tpu.models import loss as jloss
from nr3d_lib_tpu.models import utils as jutils
from nr3d_lib_tpu.models.loss import gem as jgem
from nr3d_lib_tpu_torch.graphics import nerf as tnerf
from nr3d_lib_tpu_torch.graphics import neus as tneus
from nr3d_lib_tpu_torch.graphics import raytest as traytest
from nr3d_lib_tpu_torch.models import loss as tloss
from nr3d_lib_tpu_torch.models import utils as tutils
from nr3d_lib_tpu_torch.models.loss import gem as tgem

torch.set_num_threads(1)


def _u(shape, seed: int, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _close(got, want, tol: float = 1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-12))


def _grads_match(tfn, jfn, arrays, argnums, tol: float = 1e-5):
    """The gradients of sum(f(*arrays) · w) in each of `argnums`."""
    w = _u(np.shape(np.asarray(jfn(*[jnp.asarray(a) for a in arrays]))), 99,
           0.5, 1.5)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=argnums)(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=i in argnums)
          for i, a in enumerate(arrays)]
    (tfn(*ts) * torch.from_numpy(w)).sum().backward()
    for g, i in zip(jg, argnums):
        assert _rel_l2(ts[i].grad.numpy(), g) <= tol, i


# ----------------------------------------------------- compositing helpers
def test_ray_tau_to_vw_and_composite_match_jax():
    tau = _u((64, 24), 0, 0.0, 0.5)
    _close(tnerf.ray_tau_to_vw(torch.from_numpy(tau)),
           jnerf.ray_tau_to_vw(jnp.asarray(tau)))
    vw, vals, t = _u((64, 24), 1, 0, 0.1), _u((64, 24, 3), 2), \
        np.sort(_u((64, 24), 3, 0.5, 4.0), -1)
    for depth in (None, t):
        got = tnerf.ray_composite(torch.from_numpy(vw), torch.from_numpy(vals),
                                  None if depth is None else
                                  torch.from_numpy(depth))
        want = jnerf.ray_composite(jnp.asarray(vw), jnp.asarray(vals),
                                   None if depth is None else
                                   jnp.asarray(depth))
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
    _grads_match(lambda a: tnerf.ray_tau_to_vw(a),
                 lambda a: jnerf.ray_tau_to_vw(a), [tau], (0,))
    assert tnerf.packed_alpha_to_vw is not None


@pytest.mark.parametrize("append", [False, True])
def test_neus_ray_sdf_to_vw_matches_jax(append):
    sdf = np.sort(_u((32, 16), 4, -0.5, 0.5), -1)[:, ::-1].copy()
    _close(tneus.neus_ray_sdf_to_vw(torch.from_numpy(sdf), 20.0, append),
           jneus.neus_ray_sdf_to_vw(jnp.asarray(sdf), 20.0, append))
    _grads_match(lambda a: tneus.neus_ray_sdf_to_vw(a, 20.0, append),
                 lambda a: jneus.neus_ray_sdf_to_vw(a, 20.0, append),
                 [sdf], (0,))


@pytest.mark.parametrize("append", [False, True])
def test_neus_packed_sdf_to_vw_matches_jax(append):
    counts = np.asarray([5, 1, 9, 3, 7])
    ridx = np.repeat(np.arange(5), counts).astype(np.int32)
    sdf = _u((counts.sum(),), 5, -0.5, 0.5)
    _close(tneus.neus_packed_sdf_to_vw(torch.from_numpy(sdf), 20.0,
                                       torch.from_numpy(ridx), append),
           jneus.neus_packed_sdf_to_vw(jnp.asarray(sdf), 20.0,
                                       jnp.asarray(ridx), append))


@pytest.mark.parametrize("ratio, delta_max", [(1.0, 1e10), (0.3, 0.05)])
def test_neus_estimate_sdf_nablas_to_alpha_matches_jax(ratio, delta_max):
    n = 256
    sdf, deltas = _u((n,), 6, -0.2, 0.2), _u((n,), 7, 0.0, 0.1)
    nablas, dirs = _u((n, 3), 8, -1, 1), _u((n, 3), 9, -1, 1)
    args = [sdf, deltas, nablas, dirs]

    def tf(*a):
        return tneus.neus_estimate_sdf_nablas_to_alpha(*a, 30.0, ratio,
                                                       delta_max)

    def jf(*a):
        return jneus.neus_estimate_sdf_nablas_to_alpha(*a, 30.0, ratio,
                                                       delta_max)
    _close(tf(*[torch.from_numpy(a) for a in args]),
           jf(*[jnp.asarray(a) for a in args]))
    _grads_match(tf, jf, args, (0, 2))


@pytest.mark.parametrize("center", [None, (0.2, -0.1, 0.3)])
def test_ray_sphere_intersection_matches_jax(center):
    rng = np.random.default_rng(10)
    o = rng.normal(size=(200, 3)).astype(np.float32) * 1.5
    o[:5] = 0.0                                        # starts inside
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = None if center is None else np.asarray(center, np.float32)
    got = traytest.ray_sphere_intersection(
        torch.from_numpy(o), torch.from_numpy(d), 0.8,
        None if c is None else torch.from_numpy(c))
    want = jraytest.ray_sphere_intersection(
        jnp.asarray(o), jnp.asarray(d), 0.8, None if c is None else
        jnp.asarray(c))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(got[2].sum()) < 200
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    assert traytest.ray_box_intersection_fast is \
        traytest.ray_box_intersection


# ------------------------------------------------------------- regularizers
@pytest.mark.parametrize("masked", [False, True])
def test_regularizers_match_jax(masked):
    nab, nab2 = _u((128, 3), 11, -2, 2), _u((128, 3), 12, -2, 2)
    mask = _u((128,), 13) > 0.4
    m = (torch.from_numpy(mask), jnp.asarray(mask)) if masked else \
        (None, None)
    _close(tloss.eikonal_loss(torch.from_numpy(nab), m[0]),
           jloss.eikonal_loss(jnp.asarray(nab), m[1]))
    _close(tloss.normal_smoothness_loss(torch.from_numpy(nab),
                                        torch.from_numpy(nab2), m[0]),
           jloss.normal_smoothness_loss(jnp.asarray(nab), jnp.asarray(nab2),
                                        m[1]))
    vw = _u((32, 20), 14, 0, 0.2)
    t = np.sort(_u((32, 20), 15, 0.1, 3.0), -1)
    _close(tloss.entropy_regularization(torch.from_numpy(vw)),
           jloss.entropy_regularization(jnp.asarray(vw)))
    _close(tloss.distortion_loss(torch.from_numpy(t), torch.from_numpy(vw)),
           jloss.distortion_loss(jnp.asarray(t), jnp.asarray(vw)))
    _grads_match(tloss.distortion_loss, jloss.distortion_loss, [t, vw],
                 (0, 1))
    _grads_match(tloss.entropy_regularization, jloss.entropy_regularization,
                 [vw], (0,))


# ------------------------------------------------------------------- recon
RECON = ["mse", "l2", "l1", "huber", "smooth_l1", "mape", "smape",
         "relative_l2"]


@pytest.mark.parametrize("name", RECON)
def test_recon_losses_match_jax(name):
    pred, gt = _u((16, 8, 3), 16, -1, 1), _u((16, 8, 3), 17, -1, 1)
    mask = _u((16, 8), 18) > 0.3
    for reduction in ("mean", "sum", "none"):
        for m in (None, mask):
            tf, jf = tloss.get_recon_loss(name), jloss.get_recon_loss(name)
            kw = dict(reduction=reduction)
            got = tf(torch.from_numpy(pred), torch.from_numpy(gt),
                     mask=None if m is None else torch.from_numpy(m), **kw)
            want = jf(jnp.asarray(pred), jnp.asarray(gt),
                      mask=None if m is None else jnp.asarray(m), **kw)
            _close(got, want)
    _grads_match(lambda p, g: tloss.get_recon_loss(name)(p, g, mask=None,
                                                         reduction="none"),
                 lambda p, g: jloss.get_recon_loss(name)(p, g, mask=None,
                                                         reduction="none"),
                 [pred, gt], (0, 1))


def test_get_recon_loss_binds_kwargs_and_reduce_broadcasts():
    pred, gt = _u((10, 4), 19), _u((10, 4), 20)
    got = tloss.get_recon_loss("huber", delta=0.3)(torch.from_numpy(pred),
                                                   torch.from_numpy(gt))
    _close(got, jloss.get_recon_loss("huber", delta=0.3)(
        jnp.asarray(pred), jnp.asarray(gt)))
    mask = np.zeros(10, bool)                       # an empty mask: 0 / 1
    _close(tloss.reduce(torch.from_numpy(pred), torch.from_numpy(mask)),
           jloss.reduce(jnp.asarray(pred), jnp.asarray(mask)))
    with pytest.raises(KeyError):
        tloss.get_recon_loss("nope")


# -------------------------------------------------------------------- safe
def test_safe_bce_custom_backward_matches_jax():
    # predictions past the [1e-6, 1 − 1e-6] clip and near it, where the
    # d/dp clip at ±clip_grad bites
    pred = np.concatenate([_u((60,), 21), np.asarray(
        [-0.5, 0.0, 1e-7, 1e-3, 0.999, 1.0, 1.5], np.float32)])
    gt = _u(pred.shape, 22)
    for clip in (100.0, 5.0):
        _close(tloss.safe_binary_cross_entropy(torch.from_numpy(pred),
                                               torch.from_numpy(gt), clip),
               jloss.safe_binary_cross_entropy(jnp.asarray(pred),
                                               jnp.asarray(gt), clip))
        _grads_match(
            lambda p, g: tloss.safe_binary_cross_entropy(p, g, clip),
            lambda p, g: jloss.safe_binary_cross_entropy(p, g, clip),
            [pred, gt], (0, 1))


def test_clipped_mse_custom_backward_matches_jax():
    pred, gt = _u((100,), 23, -3, 3), _u((100,), 24, -1, 1)
    for clip in (1.0, 0.25):
        _close(tloss.clipped_mse(torch.from_numpy(pred),
                                 torch.from_numpy(gt), clip),
               jloss.clipped_mse(jnp.asarray(pred), jnp.asarray(gt), clip))
        _grads_match(lambda p, g: tloss.clipped_mse(p, g, clip),
                     lambda p, g: jloss.clipped_mse(p, g, clip),
                     [pred, gt], (0, 1))
    # a scalar target broadcasts, its gradient summed
    p = torch.tensor(pred, requires_grad=True)
    tloss.clipped_mse(p, 0.5).sum().backward()
    assert p.grad.shape == p.shape


# -------------------------------------------------------------------- SSIM
@pytest.mark.parametrize("shape", [(24, 20, 3), (17, 13)])
def test_ssim_matches_jax(shape):
    a = _u(shape, 25)
    b = np.clip(a + _u(shape, 26, -0.2, 0.2), 0, 1).astype(np.float32)
    for ret_map in (False, True):
        _close(tloss.ssim(torch.from_numpy(a), torch.from_numpy(b),
                          return_map=ret_map),
               jloss.ssim(jnp.asarray(a), jnp.asarray(b),
                          return_map=ret_map), 1e-5)
    _grads_match(lambda x, y: tloss.ssim(x, y, return_map=True),
                 lambda x, y: jloss.ssim(x, y, return_map=True), [a, b],
                 (0, 1))


def test_ssim_edge_padding_not_zero_padding():
    """A constant image against itself is 1 everywhere, edges included,
    only under edge padding."""
    a = np.full((15, 15, 1), 0.7, np.float32)
    m = tloss.ssim(torch.from_numpy(a), torch.from_numpy(a),
                   return_map=True)
    np.testing.assert_allclose(m.numpy(), 1.0, rtol=0, atol=1e-5)


# --------------------------------------------------------------------- GEM
def test_gem_losses_match_jax():
    sigma = _u((200,), 27, 0, 5)
    _close(tgem.gem_density_reg(torch.from_numpy(sigma), 0.1),
           jgem.gem_density_reg(jnp.asarray(sigma), 0.1))
    acc, mask = _u((200,), 28), _u((200,), 29) > 0.5
    acc[:3] = [0.0, 1.0, 0.5]
    for m in (None, mask):
        _close(tgem.gem_opacity_loss(torch.from_numpy(acc), None if m is None
                                     else torch.from_numpy(m)),
               jgem.gem_opacity_loss(jnp.asarray(acc), None if m is None
                                     else jnp.asarray(m)))
    for fn in (tgem.clip_loss, jgem.clip_loss):
        with pytest.raises(ImportError):
            fn()


# -------------------------------------------------------------- schedulers
SCHEDULERS = {
    "constant": {"type": "constant"},
    "multistep": {"type": "multistep", "milestones": [2, 4, 4],
                  "gamma": 0.5},
    "exponential": {"type": "exponential", "num_iters": 10,
                    "min_factor": 0.1},
    "warmup_cosine": {"type": "warmup_cosine", "warmup_steps": 2,
                      "num_iters": 10},
    "plenoxels": {"type": "plenoxels", "num_iters": 10, "delay_steps": 3,
                  "delay_mult": 0.1},
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_schedulers_match_optax(name):
    cfg = SCHEDULERS[name]
    ts, js = tutils.get_scheduler(lr=1e-2, **cfg), \
        jutils.get_scheduler(lr=1e-2, **cfg)
    for step in range(21):
        want = float(js(jnp.asarray(step, jnp.int32)))
        assert abs(ts(step) - want) <= 1e-6 * max(abs(want), 1e-8), step
    if name == "warmup_cosine":
        assert ts(0) == 0.0


def test_unknown_scheduler_and_optimizer_raise():
    with pytest.raises(ValueError):
        tutils.get_scheduler("nope")
    with pytest.raises(ValueError):
        tutils.get_optimizer([torch.nn.Parameter(torch.zeros(1))], "nope")


# -------------------------------------------------------------- optimizers
OPTIMIZERS = {"adam": {}, "adamw": {}, "sgd": {}, "rmsprop": {},
              "adam_clip": {"clip_grad_norm": 1.0}}


@pytest.mark.parametrize("sched", sorted(SCHEDULERS))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_optax(name, sched):
    kind = name.split("_")[0]
    kw = dict(OPTIMIZERS[name])
    p0 = {"a": _u((6, 4), 30, -1, 1), "b": _u((5,), 31, -1, 1)}
    grads = [{k: _u(v.shape, 40 + 2 * i + j, -2, 2)
              for j, (k, v) in enumerate(p0.items())} for i in range(5)]
    tx = jutils.get_optimizer(kind, lr=1e-2, scheduler_cfg=SCHEDULERS[sched],
                              **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = tutils.get_optimizer(list(tp.values()), kind, lr=1e-2,
                               scheduler_cfg=SCHEDULERS[sched], **kw)
    assert isinstance(opt, torch.optim.Optimizer)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in p0:
            _close(tp[k].detach(), jp[k])
    assert opt.param_groups[0]["schedule_step"] == 5
    # the count travels with the state dict
    opt2 = tutils.get_optimizer(list(tp.values()), kind, lr=1e-2,
                                scheduler_cfg=SCHEDULERS[sched], **kw)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.param_groups[0]["schedule_step"] == 5


def test_torch_rmsprop_is_not_optax_rmsprop():
    """The reason RMSprop is written out: torch's defaults step
    elsewhere."""
    p0, g = _u((8,), 50, -1, 1), _u((8,), 51, -2, 2)
    jp = jnp.asarray(p0)
    tx = optax.rmsprop(1e-2)
    upd, _ = tx.update(jnp.asarray(g), tx.init(jp))
    want = np.asarray(optax.apply_updates(jp, upd))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    p.grad = torch.from_numpy(g)
    torch.optim.RMSprop([p], lr=1e-2).step()
    assert np.abs(p.detach().numpy() - want).max() > 1e-3
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    p.grad = torch.from_numpy(g)
    tutils.get_optimizer([p], "rmsprop", lr=1e-2).step()
    _close(p.detach(), want)


# ---------------------------------------------------------------- the rest
def test_batchify_query_matches_jax():
    x, y = _u((37, 3), 52), _u((37, 2), 53)

    def tf(a, b):
        return {"s": a.sum(-1), "c": torch.cat([a, b], -1)}, (a * 2.0,)

    def jf(a, b):
        return {"s": a.sum(-1), "c": jnp.concatenate([a, b], -1)}, (a * 2.0,)

    for chunk in (8, 64):
        got = tutils.batchify_query(lambda a, b: tf(a, b)[0],
                                    torch.from_numpy(x), torch.from_numpy(y),
                                    chunk=chunk)
        want = jutils.batchify_query(lambda a, b: jf(a, b)[0],
                                     jnp.asarray(x), jnp.asarray(y),
                                     chunk=chunk)
        for k in want:
            _close(got[k], want[k])
        got = tutils.batchify_query(lambda a: tf(a, a[:, :2])[1],
                                    torch.from_numpy(x), chunk=chunk)
        assert isinstance(got, tuple)
        _close(got[0], 2.0 * x)
        got = tutils.batchify_query(lambda a: a[:, :1], torch.from_numpy(x),
                                    chunk=chunk)
        _close(got, x[:, :1])


def test_grad_norms_and_clip_match_jax():
    g = {"a": _u((6, 4), 54, -2, 2), "b": _u((5,), 55, -2, 2)}
    ps = [torch.nn.Parameter(torch.zeros(v.shape)) for v in g.values()]
    for p, v in zip(ps, g.values()):
        p.grad = torch.from_numpy(v.copy())
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    for norm_type in (2.0, float("inf")):
        _close(tutils.calc_grad_norm(ps, norm_type),
               jutils.calc_grad_norm(jg, norm_type))
    for max_norm in (1.0, 100.0):               # clipped, then not
        want, wn = jutils.clip_grad_norm(jg, max_norm)
        got, gn = tutils.clip_grad_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        _close(gn, wn)
        for k in g:
            _close(got[k], want[k])
        got_list, _ = tutils.clip_grad_norm(
            [torch.from_numpy(v) for v in g.values()], max_norm)
        assert isinstance(got_list, list)
        _close(got_list[0], want["a"])


# ------------------------------------------ the public names
# Every module of the JAX package, found by walking its files: the names
# of its `__all__`, or (without one) its public top-level functions and
# classes, read with `ast`. Each must exist in the port's module at the
# same path (and be in its `__all__` where JAX's has one). The port
# renames three JAX-specific utils names and nothing else.
JAX_ROOT = Path(__file__).resolve().parents[1] / "nr3d_lib_tpu"
RENAMES = {("utils", "jax_dtype"): "torch_dtype",
           ("utils", "check_to_jax"): "check_to_torch",
           ("utils", "timeit_jax"): "timeit_torch"}


def _module_names(path):
    """(dotted module path, [public names], whether from `__all__`)."""
    rel = path.relative_to(JAX_ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ".".join(parts), list(ast.literal_eval(node.value)), True
    return ".".join(parts), [n.name for n in tree.body if isinstance(
        n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")], \
        False


MODULES = [_module_names(p) for p in sorted(JAX_ROOT.rglob("*.py"))]
MODULES = [m for m in MODULES if m[0] and m[1]]
# names outside an `__all__` (module, names)
EXTRA_NAMES = [
    ("graphics.cameras", ("fisheye_undistort", "smoothed_motion_interpolation",
                          "path_small_circle", "path_spherical_spiral",
                          "path_interpolation")),
    ("maths", ("quaternion_to_matrix", "matrix_to_quaternion",
               "axis_angle_to_matrix", "matrix_to_axis_angle",
               "axis_angle_to_quaternion", "quaternion_to_axis_angle",
               "rotation_6d_to_matrix", "matrix_to_rotation_6d",
               "quaternion_multiply", "quaternion_invert",
               "quaternion_apply", "slerp", "logistic_density",
               "logistic_cdf", "normalize", "knn_points", "knn_gather",
               "chamfer_distance", "dist_to_nn3_mean", "depth_completion")),
    ("ops.lotd_brick4", ("brick4_encode_frozen_x",)),
]
METHODS = {
    ("models.accelerations.occgrid", "OccGridEma"): (
        "occ", "occupancy_ratio", "query", "collect_samples", "try_shrink",
        "init_from_net", "step_update"),
    ("models.accelerations.occgrid", "OccGridGetter"): ("occ", "update"),
    ("models.accelerations.occgrid_accel", "OccGridAccel"): (
        "init", "step", "collect_samples", "query", "ray_march",
        "try_shrink", "debug_stats"),
    ("models.spatial.aabb", "AABBSpace"): (
        "scale", "normalize_coords", "unnormalize_coords", "normalize_rays",
        "ray_test", "rescale_volume", "sample_pts_uniform"),
    ("models.blocks", "LipshitzMLP"): ("lipshitz_bound_full",),
    ("models.blocks", "MLP"): ("get_weight_reg",),
}


@pytest.mark.parametrize("name, names, in_all", MODULES,
                         ids=[m for m, _, _ in MODULES])
def test_public_names_match_jax(name, names, in_all):
    import importlib

    tm = importlib.import_module(f"nr3d_lib_tpu_torch.{name}")
    missing = [n for n in names
               if not hasattr(tm, RENAMES.get((name, n), n))
               or (in_all and RENAMES.get((name, n), n)
                   not in getattr(tm, "__all__", ()))]
    assert not missing, missing
    for n in getattr(tm, "__all__", ()):
        assert hasattr(tm, n), n
    for (mod, cls), methods in METHODS.items():
        if mod == name:
            jm = importlib.import_module(f"nr3d_lib_tpu.{name}")
            for m in methods:
                assert hasattr(getattr(jm, cls), m), (cls, m)
                assert hasattr(getattr(tm, cls), m), (cls, m)


def test_the_inventory_walks_the_whole_package():
    names = {m for m, _, _ in MODULES}
    assert {"config", "utils", "parallel", "parallel.pipeline", "viewer",
            "plot.plot_3d", "models.blocks", "ops.chunking",
            "checkpoint_sharded"} <= names
    assert len(MODULES) > 80


@pytest.mark.parametrize("name, names", EXTRA_NAMES,
                         ids=[m for m, _ in EXTRA_NAMES])
def test_public_names_outside_all(name, names):
    import importlib

    jm = importlib.import_module(f"nr3d_lib_tpu.{name}")
    tm = importlib.import_module(f"nr3d_lib_tpu_torch.{name}")
    for n in names:
        assert hasattr(jm, n), n
        assert callable(getattr(tm, n, None)), n
