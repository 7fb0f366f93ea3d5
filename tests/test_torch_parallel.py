"""The port's `parallel` package and `checkpoint_sharded` on gloo groups of
2 and 4 CPU processes, held against the JAX package on meshes of as many
of the conftest's CPU devices.

Each group is started once (by `spawn`; the rank body is
`tests/torch_parallel_ranks.py`, which imports no JAX), runs every check
and writes what each rank got; the tests read it here. The group joins
through a file in the test's tmp dir, each rank's group has a 60 s
timeout, and the join a deadline, so a hung rank fails its tests.

* `parallel.init_env` joins each rank from torchrun's variables (rank,
  world size, local rank, gloo without a card, the seed); one process
  makes no group, and `make_mesh` refuses `WORLD_SIZE` > 1 without one;
  in a group of one the step runs no collective and equals a plain step.
* `make_sharded_train_step` on JAX's own test problem (tests/
  test_parallel.py:12: a linear map, SGD(0.1)): loss and parameters
  against JAX's step on the mesh.
* `forest_encode_block_sharded` (data × block: 1 × 2 and 2 × 2):
  features within 1e-6 of JAX's; the train step's block gradients within
  1e-5 relative of `jax.grad` of JAX's single-device loss (each on its
  owner, zeros elsewhere: not world-size times), parameters after
  SGD(0.5).
* `brick_encode_table_sharded` over a ``model`` axis of 2 and 4: values
  and dL/dtable against JAX's.
* `pipeline_apply` with S = 2 and 4 stages, M = 4: values and the stage
  gradients against JAX's.
* `save_sharded`/`load_sharded`: a `Shard(0)` table reloaded as
  `Replicate()` on every rank, and onto this one process, bitwise.
* A small F=4 NeuS step on 2 ranks (each its half of the rays, its own
  draws) against one process on the two halves: losses within 1e-6,
  step 1's gradients within 1e-5 and the parameters after 2 Adam steps
  within 1e-4 relative L2; both ranks' parameters and occupancy grids
  the same bits.
"""

import multiprocessing as mp
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_ranks as R

torch.set_num_threads(1)
WORLDS = [2, 4]
_GROUPS = {}
_FOREST_JAX = {}


def _inputs() -> dict:
    from nr3d_lib_tpu_torch.ops import lotd as L
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    rng = np.random.default_rng(0)

    def f32(a):
        return np.asarray(a, np.float32)

    meta = L.generate_meta(3, [4, 6], 2, "Dense")
    bmeta = B.make_brick_meta([16, 32, 256], ["Dense", "Dense", "Hash"],
                              hashmap_rows=512)
    return {**R.neus_inputs(1),
        "dp_w": np.ones((3, 4), np.float32), "dp_b": np.zeros(4, np.float32),
        "dp_x": f32(rng.normal(size=(64, 3))),
        "dp_y": f32(rng.normal(size=(64, 4))),
        "forest_params": f32(0.1 * rng.normal(size=(7, meta.n_params))),
        "forest_x": f32(rng.uniform(size=(64, 3))),
        "forest_bidx": rng.integers(-1, 7, 64).astype(np.int32),
        "forest_tgt": f32(rng.normal(size=(64, 1))),
        "forest_w": f32(0.01 * rng.normal(size=(4, 1))),
        "table": f32(rng.standard_normal((bmeta.total_rows, 128)) * 0.1),
        "table_x": f32(rng.uniform(0.01, 0.99, (256, 3))),
        "pipe_ws": f32(rng.standard_normal((4, 16, 16)) * 0.3),
        "pipe_xs": f32(rng.standard_normal((4, 8, 16))),
        "ckpt_table": f32(rng.standard_normal((8, 32))),
        "ckpt_mlp": f32(rng.standard_normal((16, 4))),
    }


def _group(world: int, tmp_path_factory):
    """Run the ranks once per group size; (inputs, [rank outputs], dir)."""
    if world not in _GROUPS:
        work = str(tmp_path_factory.mktemp(f"gloo{world}"))
        inp = _inputs()
        torch.save(inp, os.path.join(work, "inputs.pt"))
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=R.run, args=(r, world, work))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(150)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in procs]
        assert not alive and codes == [0] * world, codes
        outs = [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
        _GROUPS[world] = (inp, outs, work)
    return _GROUPS[world]


def _mesh(world: int, shape, names):
    return Mesh(np.asarray(jax.devices()[:world]).reshape(shape), names)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------- the group
@pytest.mark.parametrize("world", WORLDS)
def test_init_env_joins_from_torchrun_variables(world, tmp_path_factory):
    _, outs, _ = _group(world, tmp_path_factory)
    torch.manual_seed(7)
    draw = float(torch.rand(()))
    for r, out in enumerate(outs):
        assert out["env"] == (r, world, r, r == 0, "gloo")
        assert out["env_draw"] == draw


def test_init_env_makes_no_group_for_one_process(monkeypatch):
    from nr3d_lib_tpu_torch import parallel

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    parallel.init_env(seed=3)
    assert not dist.is_initialized()
    assert (parallel.rank(), parallel.world_size(), parallel.is_master()) \
        == (0, 1, True)
    # a process torchrun started as one of two, without init_env: no
    # quiet world of one
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="init_env"):
        parallel.make_mesh()
    assert not dist.is_initialized()


def test_world_of_one_step_runs_no_collective(monkeypatch):
    from nr3d_lib_tpu_torch import parallel
    from nr3d_lib_tpu_torch.parallel.train import (make_sharded_train_step,
                                                   replicate, shard_rays)

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    inp = _inputs()
    mesh = parallel.make_mesh()
    try:
        assert dist.get_world_size() == 1
        for name in ("all_reduce", "broadcast"):
            monkeypatch.setattr(dist, name, lambda *a, **k: pytest.fail(
                "a collective in a group of one"))
        models = []
        for sharded in (True, False):
            p = {k: torch.nn.Parameter(torch.from_numpy(inp[f"dp_{k}"]))
                 for k in ("w", "b")}
            if sharded:
                p = {k: torch.nn.Parameter(v) for k, v in
                     replicate(dict(p), mesh).items()}
            opt = torch.optim.SGD(p.values(), lr=0.1)
            batch = {"x": torch.from_numpy(inp["dp_x"]),
                     "y": torch.from_numpy(inp["dp_y"])}

            def loss_fn(b, generator, p=p):
                return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

            if sharded:
                loss = make_sharded_train_step(loss_fn, opt, mesh)(
                    shard_rays(batch, mesh))
            else:
                opt.zero_grad()
                loss = loss_fn(batch, None)
                loss.backward()
                opt.step()
            models.append((float(loss.detach()), p))
        (l1, p1), (l2, p2) = models
        assert l1 == l2 and all(torch.equal(p1[k], p2[k]) for k in p1)
    finally:
        dist.destroy_process_group()
        parallel._STATE["mesh"] = None


# ------------------------------------------------------ data parallel
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_train_step_matches_jax(world, tmp_path_factory):
    from nr3d_lib_tpu.parallel import make_mesh
    from nr3d_lib_tpu.parallel.train import (make_sharded_train_step,
                                             replicate, shard_rays)

    inp, outs, _ = _group(world, tmp_path_factory)
    mesh = make_mesh(devices=jax.devices()[:world])
    w0 = {"w": jnp.asarray(inp["dp_w"]), "b": jnp.asarray(inp["dp_b"])}
    batch = {"x": jnp.asarray(inp["dp_x"]), "y": jnp.asarray(inp["dp_y"])}
    opt = optax.sgd(0.1)

    def loss_fn(params, b, key):
        pred = b["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - b["y"]) ** 2)

    step = make_sharded_train_step(loss_fn, opt, mesh, donate=False)
    p1, _, loss = step(replicate(w0, mesh), replicate(opt.init(w0), mesh),
                       shard_rays(batch, mesh), None)
    for r, out in enumerate(outs):
        assert out["dp_rows"] == 64 // world
        np.testing.assert_allclose(float(out["dp_loss"]), float(loss),
                                   rtol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(out[f"dp_{k}"].numpy(),
                                       np.asarray(p1[k]), rtol=1e-6,
                                       atol=1e-7)
            assert torch.equal(out[f"dp_{k}"], outs[0][f"dp_{k}"]), (r, k)


# ---------------------------------------------------------- the forest
def _forest_jax(world, inp):
    """JAX's sharded features, single-device gradients, stepped parameters
    and loss (jitted: JAX's eager shard_map takes ~30 s here); cached by
    group size."""
    if world in _FOREST_JAX:
        return _FOREST_JAX[world]
    from nr3d_lib_tpu.ops import lotd as L
    from nr3d_lib_tpu.parallel.forest_parallel import (
        forest_encode_block_sharded, make_forest_sharded_train_step,
        pad_blocks_for_sharding)

    n_data = 2 if world == 4 else 1
    n_block = world // n_data
    mesh = _mesh(world, (n_data, n_block), ("data", "block"))
    meta = L.generate_meta(3, [4, 6], 2, "Dense")
    blocks = pad_blocks_for_sharding(jnp.asarray(inp["forest_params"]),
                                     n_block)
    x, bidx = jnp.asarray(inp["forest_x"]), jnp.asarray(inp["forest_bidx"])
    tgt, w = jnp.asarray(inp["forest_tgt"]), jnp.asarray(inp["forest_w"])
    p_sh = jax.device_put(blocks, NamedSharding(mesh, P("block", None)))
    x_sh = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    b_sh = jax.device_put(bidx, NamedSharding(mesh, P("data")))
    feats = jax.jit(lambda a, b, c: forest_encode_block_sharded(
        a, b, c, meta, mesh, data_axis="data"))(x_sh, b_sh, p_sh)
    opt = optax.sgd(0.5)

    def loss_fn(other, f, batch):
        return jnp.mean((f @ other - batch["tgt"]) ** 2)

    params = {"blocks": blocks, "other": w}

    def single_loss(p):
        f = L.lotd_encode(x, p["blocks"], meta, bidx=bidx)
        return loss_fn(p["other"], f, {"tgt": tgt})

    grads = jax.jit(jax.grad(single_loss))(params)
    step = make_forest_sharded_train_step(loss_fn, opt, meta, mesh)
    params_sh = {"blocks": p_sh,
                 "other": jax.device_put(w, NamedSharding(mesh, P()))}
    batch = {"x": x_sh, "bidx": b_sh, "tgt": jax.device_put(
        tgt, NamedSharding(mesh, P("data", None)))}
    p1, _, loss = step(params_sh, opt.init(params_sh), batch, None)
    _FOREST_JAX[world] = (np.asarray(feats), grads,
                          {k: np.asarray(v) for k, v in p1.items()},
                          float(loss), n_block)
    return _FOREST_JAX[world]


@pytest.mark.parametrize("world", WORLDS)
def test_forest_encode_block_sharded_matches_jax(world, tmp_path_factory):
    inp, outs, _ = _group(world, tmp_path_factory)
    feats, _, _, _, _ = _forest_jax(world, inp)
    n_data = 2 if world == 4 else 1
    k = 64 // n_data
    for out in outs:
        c = out["forest_data_rank"]
        np.testing.assert_allclose(out["forest_feats"].numpy(),
                                   feats[c * k:(c + 1) * k], rtol=0,
                                   atol=1e-6)
    assert float(np.abs(feats).max()) > 0.05


@pytest.mark.parametrize("world", WORLDS)
def test_forest_train_step_matches_jax(world, tmp_path_factory):
    inp, outs, _ = _group(world, tmp_path_factory)
    _, grads, p1, loss, n_block = _forest_jax(world, inp)
    g_blocks = np.asarray(grads["blocks"])
    rows = g_blocks.shape[0] // n_block
    for out in outs:
        b = out["forest_block_rank"]
        own = slice(b * rows, (b + 1) * rows)
        np.testing.assert_allclose(float(out["forest_loss"]), loss,
                                   rtol=1e-5)
        # the owner's rows of jax.grad of the single-device loss: not
        # world-size times them
        assert _rel_l2(out["forest_grad_own"].numpy(), g_blocks[own]) \
            <= 1e-5
        assert out["forest_grad_other_rows"] == 0.0
        np.testing.assert_allclose(out["forest_blocks_own"].numpy(),
                                   p1["blocks"][own], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(out["forest_other"].numpy(), p1["other"],
                                   rtol=1e-4, atol=1e-6)
    assert np.abs(g_blocks).sum() > 0


# ------------------------------------------------------ table parallel
@pytest.mark.parametrize("world", WORLDS)
def test_table_sharded_matches_jax(world, tmp_path_factory):
    from nr3d_lib_tpu.ops import lotd_brick as B
    from nr3d_lib_tpu.parallel.table_parallel import (
        brick_encode_table_sharded, pad_table_for_sharding)

    inp, outs, _ = _group(world, tmp_path_factory)
    mesh = _mesh(world, (1, world), ("data", "model"))
    meta = B.make_brick_meta([16, 32, 256], ["Dense", "Dense", "Hash"],
                             hashmap_rows=512)
    t_pad = pad_table_for_sharding(jnp.asarray(inp["table"]), world)
    t_sh = jax.device_put(t_pad, NamedSharding(mesh, P("model")))
    x = jnp.asarray(inp["table_x"])

    def f(tt):
        return brick_encode_table_sharded(x, tt, meta, mesh, "model")

    y = np.asarray(jax.jit(f)(t_sh))
    g = np.asarray(jax.jit(jax.grad(lambda tt: jnp.sum(f(tt) ** 2)))(t_sh))
    rows = t_pad.shape[0] // world
    total = np.zeros_like(g)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["table_y"].numpy(), y, rtol=0,
                                   atol=1e-6)
        gr = out["table_grad"].numpy()
        own = slice(r * rows, (r + 1) * rows)
        assert np.abs(np.delete(gr, np.s_[own], axis=0)).sum() == 0
        total += gr
    assert _rel_l2(total, g) <= 1e-5


# ------------------------------------------------------------ pipeline
@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_jax(world, tmp_path_factory):
    from nr3d_lib_tpu.parallel.pipeline import pipeline_apply

    inp, outs, _ = _group(world, tmp_path_factory)
    mesh = _mesh(world, (world,), ("stage",))
    ws = jnp.asarray(inp["pipe_ws"][:world])
    xs = jnp.asarray(inp["pipe_xs"])

    def stage_fn(w, h):
        return jnp.tanh(h @ w)

    ws_sh = jax.device_put(ws, NamedSharding(mesh, P("stage")))
    y = jax.jit(lambda w: pipeline_apply(stage_fn, w, xs, mesh))(ws_sh)
    g = jax.jit(jax.grad(lambda w: jnp.sum(
        pipeline_apply(stage_fn, w, xs, mesh) ** 2)))(ws_sh)
    g = np.asarray(g)
    for s, out in enumerate(outs):
        np.testing.assert_allclose(out["pipe_y"].numpy(), np.asarray(y),
                                   rtol=1e-5, atol=1e-6)
        gs = out["pipe_grad"].numpy()
        np.testing.assert_allclose(gs[s], g[s], rtol=1e-4, atol=1e-5)
        assert np.abs(np.delete(gs, s, axis=0)).sum() == 0
        assert np.abs(gs[s]).sum() > 0


# ---------------------------------------------------------- checkpoint
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_checkpoint_reshards(world, tmp_path_factory):
    from nr3d_lib_tpu_torch.checkpoint_sharded import load_sharded

    inp, outs, work = _group(world, tmp_path_factory)
    full = torch.from_numpy(inp["ckpt_table"])
    rows = full.shape[0] // world
    for r, out in enumerate(outs):
        assert torch.equal(out["ckpt_same_local"],
                           full[r * rows:(r + 1) * rows])
        assert out["ckpt_same_placement"] == "(Shard(dim=0),)"
        assert torch.equal(out["ckpt_replicated"], full)
        assert out["ckpt_placement"] == "(Replicate(),)"
        assert torch.equal(out["ckpt_mlp"], torch.from_numpy(inp["ckpt_mlp"]))
        assert out["ckpt_it"] == 10
    # onto one process, without a group
    one = load_sharded(os.path.join(work, "ckpt"),
                       {"blocks": torch.zeros_like(full),
                        "mlp": torch.zeros(16, 4), "it": 0})
    assert torch.equal(one["blocks"], full)
    assert torch.equal(one["mlp"], torch.from_numpy(inp["ckpt_mlp"]))
    assert one["it"] == 10


# --------------------------------------------- the F=4 NeuS on 2 ranks
def test_neus_ddp_step_matches_one_process(tmp_path_factory):
    inp, outs, _ = _group(2, tmp_path_factory)
    want_loss, grads, params = R.neus_reference(inp)
    for out in outs:
        np.testing.assert_allclose(out["neus_losses"].numpy(),
                                   want_loss.numpy(), rtol=1e-6)
        assert set(out["neus_grads"][0]) == set(grads[0])
        for k, g in grads[0].items():
            assert _rel_l2(out["neus_grads"][0][k].numpy(), g.numpy()) \
                <= 1e-5, k
        for k, p in params.items():
            assert _rel_l2(out["neus_params"][k].numpy(), p.numpy()) <= 1e-4, k
    for k, p in outs[0]["neus_params"].items():
        assert torch.equal(p, outs[1]["neus_params"][k]), k
    assert torch.equal(outs[0]["neus_occ"], outs[1]["neus_occ"])
    assert float(want_loss[0]) > 0
