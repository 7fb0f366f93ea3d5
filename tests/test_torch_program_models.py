"""Port parity: the program layer on models, against the JAX package on
the CPU, at a small size.

* `extract_mesh` from bridged weights (the classic-LoTD NeuS of
  examples/train_neus_object.py at a small width, tables at ±0.1): the
  same faces as JAX's, vertices within 1e-5.
* `render_turntable` from the same weights: at least 99% of the pixels
  of every frame equal to JAX's, the rest within one 8-bit level. The
  JAX side of both runs with x64 off, as the JAX example runs (the
  suite's conftest turns it on, and under it JAX computes some of the
  march in float64).
* A JAX checkpoint read by the port: a few JAX steps of the example's
  step (MSE + 0.03·eikonal, clip 5, Adam(3e-3)) at the smoke size,
  `nr3d_lib_tpu.checkpoint.CheckpointIO.save`, the msgpack read back with
  flax here, loaded into the port model through the state bridge; the
  port's render of seeded rays against the JAX model's (at least 99% of
  the rays within 1e-4, as PERF.md §2).
* The state audit: for each example trainer's model, at the trainer's
  own configuration, the JAX model's `nnx.state` paths are the port's
  `state_dict` keys (so a port checkpoint carries whatever the JAX one
  does).
* Resume on the CPU through `CheckpointIO` (model, Adam state and the
  run's generator): the losses of steps k and k+1 of a run resumed at
  step k bitwise equal to the uninterrupted run's, for the NeuS object,
  the forest, EmerNeRF and the generative shapes (one CPU thread: a
  multithreaded scatter-add sums in another order from run to run).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx, serialization

from nr3d_lib_tpu.checkpoint import CheckpointIO as JaxCheckpointIO
from nr3d_lib_tpu.graphics.trianglemesh import extract_mesh as j_extract
from nr3d_lib_tpu.gui import render_turntable as j_turntable
from nr3d_lib_tpu.models.fields_forest import LoTDForestNeuSModel as JForest
from nr3d_lib_tpu.models.model_base import LoTDNeRFModel as JNeRF
from nr3d_lib_tpu.models.model_base import LoTDNeuSModel as JNeuS
from nr3d_lib_tpu.models import model_families as JM
from nr3d_lib_tpu_torch.bridge import forest_from_jax_state, from_jax_state
from nr3d_lib_tpu_torch.graphics.trianglemesh import extract_mesh
from nr3d_lib_tpu_torch.gui import render_turntable
from nr3d_lib_tpu_torch.models import model_families as TM
from nr3d_lib_tpu_torch.models.fields_forest import \
    LoTDForestNeuSModel as TForest
from nr3d_lib_tpu_torch.models.model_base import LoTDNeRFModel as TNeRF
from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel as TNeuS
from test_torch_query_modes import (_flat, _jax_render, _occ, _pair, _rays,
                                    _render_close)

from examples_torch import (train_conditional_dynamic, train_dynamic_scene,
                            train_forest_street, train_generative_shapes,
                            train_nerf_synthetic, train_neus_object)
from examples_torch.common import resume_losses

torch.set_num_threads(1)

# examples/train_neus_object.py's model at a small width: the classic
# LoTD, Dense/Dense/Hash, march_occ_multi_upsample
LOTD = {"lod_res": [8, 16, 32], "lod_n_feats": 2,
        "lod_types": ["Dense", "Dense", "Hash"], "hashmap_size": 2 ** 10}
NEUS = dict(field_cfg={"surface_cfg": {"encoding_cfg": {"lotd_cfg": LOTD},
                                       "decoder_cfg": {"D": 1, "W": 16}},
                       "radiance_cfg": {"D": 2, "W": 16},
                       "var_ctrl_cfg": {"type": "learned",
                                        "init_val": 64.0}},
            accel_cfg={"resolution": 16, "max_steps_per_ray": 32,
                       "step_size": 2.0 / 32},
            ray_query_cfg={"query_mode": "march_occ_multi_upsample",
                           "upsample_inv_s_factors": [1.0, 4.0],
                           "n_importance": 8})
TABLE = "field/implicit_surface/encoding/flattened_params"


@pytest.fixture(scope="module")
def neus():
    return _pair(JNeuS, TNeuS, NEUS, TABLE, _occ())


def test_extract_mesh_matches_jax(neus, tmp_path):
    jm, tm = neus
    with jax.enable_x64(False):   # as the JAX example runs
        jv, jf = j_extract(lambda x: jm.forward_sdf(jnp.asarray(x))["sdf"],
                           resolution=24, chunk=4096,
                           filepath=str(tmp_path / "j.obj"))
    with torch.no_grad():
        tv, tf = extract_mesh(lambda x: tm.forward_sdf(x)["sdf"],
                              resolution=24, chunk=4096,
                              filepath=str(tmp_path / "t.obj"), device="cpu")
    assert len(jf) > 100
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)


def test_render_turntable_matches_jax(neus, tmp_path):
    jm, tm = neus
    kw = dict(n_frames=3, radius=2.5, elevation=0.4, hw=(24, 32))
    with jax.enable_x64(False):   # as the JAX example runs
        jf = np.stack(j_turntable(jm, **kw))
    tf = np.stack(render_turntable(tm, **kw, out_dir=str(tmp_path)))
    assert sorted(os.listdir(tmp_path))[:3] == [
        f"frame_{i:04d}.png" for i in range(3)]
    diff = np.abs(tf.astype(np.int32) - jf.astype(np.int32))
    for i in range(3):
        assert float((diff[i] == 0).mean()) >= 0.99, i
    assert int(diff.max()) <= 1
    assert float(jf.astype(np.float32).std()) > 1.0     # not vacuous


def _example_step(graphdef, rest, opt):
    @jax.jit
    def step(params, opt_state, o, d, key):
        def loss_fn(p):
            m = nnx.merge(graphdef, p, rest)
            rendered, vb = m.ray_query(m.ray_test(o, d), key=key)
            eik = jnp.mean((jnp.linalg.norm(vb["nablas"], axis=-1) - 1.0)
                           ** 2)
            return jnp.mean((rendered["rgb_volume"] - jnp.abs(d)) ** 2) \
                + 0.03 * eik

        g = jax.grad(loss_fn)(params)
        upd, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, upd), opt_state
    return step


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jm = JNeuS(**NEUS)
    flat0 = _flat(nnx.state(jm))
    state = nnx.state(jm)
    rng = np.random.default_rng(0)
    for k, v in nnx.to_flat_state(state):
        path = "/".join(str(p) for p in k)
        if path == TABLE:
            v[...] = jnp.asarray(rng.uniform(-0.1, 0.1, flat0[path].shape)
                                 .astype(np.float32))
        elif path == "accel/occ/val_grid":
            v[...] = jnp.asarray(_occ())
    nnx.update(jm, state)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(3e-3))
    opt_state = opt.init(params)
    step = _example_step(graphdef, rest, opt)
    for i in range(3):
        o, d = _rays(128, 10 + i)
        params, opt_state = step(params, opt_state, jnp.asarray(o),
                                 jnp.asarray(d), jax.random.key(i))
    nnx.update(jm, params)
    io = JaxCheckpointIO(str(tmp_path / "ckpts"))
    io.register_modules(model=jm)
    path = io.save("ckpt_final.msgpack", it=3, psnr=1.5)

    with open(path, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    assert payload["__extras__"] == {"it": 3, "psnr": 1.5}
    flat = dict(_leaves(payload["model"]))
    tm = TNeuS(**NEUS, device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    assert not np.array_equal(flat[TABLE], flat0[TABLE])   # trained
    o, d = _rays(512, 20)
    rj = _jax_render(jm, o, d, None)
    with torch.no_grad():
        rt, _ = tm.ray_query(tm.ray_test(torch.from_numpy(o),
                                         torch.from_numpy(d)))
    _render_close(rt, rj)


# ------------------------------------------------------------- state audit
AUDIT = {
    "neus_object": (JNeuS, TNeuS, lambda: train_neus_object.model_cfg(
        train_neus_object.parse([])), from_jax_state),
    "neus_object_w4": (JNeuS, TNeuS, lambda: train_neus_object.model_cfg(
        train_neus_object.parse(["--w4"])), from_jax_state),
    "nerf_synthetic": (JNeRF, TNeRF, lambda: train_nerf_synthetic.model_cfg(
        train_nerf_synthetic.parse([])), from_jax_state),
    "forest_street": (JForest, TForest, lambda: train_forest_street.model_cfg(
        train_forest_street.parse([])), forest_from_jax_state),
    "dynamic_scene": (JM.EmerNeRFModel, TM.EmerNeRFModel,
                      lambda: train_dynamic_scene.MODEL_CFG, from_jax_state),
    "generative_shapes": (JM.GenerativePermutoNeuSModelBatched,
                          TM.GenerativePermutoNeuSModelBatched,
                          lambda: train_generative_shapes.MODEL_CFG,
                          from_jax_state),
    "conditional_dynamic": (JM.DynamicGenerativeNeuSModel,
                            TM.DynamicGenerativeNeuSModel,
                            lambda: train_conditional_dynamic.MODEL_CFG,
                            from_jax_state),
}


@pytest.mark.parametrize("name", sorted(AUDIT))
def test_port_state_dict_carries_the_jax_state(name):
    jcls, tcls, cfg, bridge = AUDIT[name]
    jm, tm = jcls(**cfg()), tcls(**cfg(), device="cpu")
    # the suite's x64 makes JAX's keyframe times float64: only the keys
    # and shapes are compared
    want = bridge({k: v.astype(np.float32) if v.dtype == np.float64 else v
                   for k, v in _flat(nnx.state(jm)).items()})
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k


# ------------------------------------------------------------------ resume
RESUME = {"neus_object": train_neus_object,
          "forest_street": train_forest_street,
          "dynamic_scene": train_dynamic_scene,
          "generative_shapes": train_generative_shapes}


@pytest.mark.parametrize("name", sorted(RESUME))
def test_resumed_run_repeats_the_losses(name, tmp_path):
    """Resumed at k = 15, so that step 16 runs an occupancy update from
    the loaded grids."""
    mod = RESUME[name]
    args = mod.parse(["--cpu", "--rays", "64"])
    straight, resumed = resume_losses(lambda: mod.setup(args), 15,
                                      str(tmp_path))
    assert straight == resumed, (straight, resumed)
    assert all(np.isfinite(straight))
