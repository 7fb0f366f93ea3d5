"""The rank body of `tests/test_torch_parallel.py` (and of the two-rank
step in `tests/test_torch_kernels_gpu.py`): one process of a gloo group,
started by `spawn`, runs the port's `parallel` and `checkpoint_sharded`
functions on the inputs the test wrote and saves what it got for the
test to hold against JAX (or, on the card, against one process).
Imports neither JAX nor the JAX package.

`run(rank, world, work_dir, device)` reads `work_dir/inputs.pt`, joins
the group through `work_dir/init` (a file store, no TCP port; on the CPU
by `parallel.init_env` from torchrun's variables), and writes
`work_dir/rank<r>.pt`. Every rank takes part in every check, in the same
order.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# a small F=4 NeuS on the brick backend (tests/test_torch_train_step.py)
NEUS_CFG = dict(
    field_cfg={"surface_cfg": {
        "encoding_cfg": {"lotd_cfg": {"lod_res": [16, 64], "lod_n_feats": 4,
                                      "lod_types": ["Dense", "Hash"],
                                      "hashmap_size": 2 ** 16},
                         "backend": "brick", "hashmap_rows": 64},
        "decoder_cfg": {"D": 1, "W": 16}},
        "radiance_cfg": {"D": 2, "W": 16}},
    accel_cfg={"resolution": 16, "max_steps_per_ray": 32,
               "step_size": 2.0 / 32},
    ray_query_cfg={"query_mode": "march_occ_multi_upsample_compressed",
                   "compression_factor": 0.25, "march_budget_factor": 0.5,
                   "n_importance": 8})
NEUS_STEPS = 2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def neus_inputs(seed: int = 0) -> dict:
    """The small NeuS's encoding table and 128 rays, from numpy."""
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    rng = np.random.default_rng(seed)
    n = LoTDNeuSModel(**NEUS_CFG, seed=0, device="cpu").field. \
        implicit_surface.encoding.flattened_params.numel()
    o = rng.normal(size=(128, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(128, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return {"neus_table": rng.uniform(-0.1, 0.1, n).astype(np.float32),
            "neus_o": o.astype(np.float32), "neus_d": d.astype(np.float32)}


def neus_model(table: np.ndarray, device="cpu"):
    """The small NeuS with `table` as its encoding's parameters and its
    occupancy grid populated."""
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    m = LoTDNeuSModel(**NEUS_CFG, seed=0, device=device)
    with torch.no_grad():
        m.field.implicit_surface.encoding.flattened_params.copy_(_t(table))
        m.field.var_ctrl.ln_s.fill_(float(np.log(64.0) / 10.0))
    m.populate()
    return m


def halves_reference(model, loss_fn, o, d, seeds, steps: int,
                     lr: float = 5e-3, before_step=None, forced=None):
    """The data-parallel step's reference: one process on the ranks' equal
    shares of the rays `o`, `d` (one share a seed), each with its own
    draws (a generator seeded `seeds[r]`). Per step (it = 1, 2, ...):
    `before_step(it)` if given, each share's `loss_fn(o, d, generator)`
    and gradients, their means, Adam(lr) on `model`'s parameters.

    `forced`, one dict of gradients by name a step, are the mean
    gradients a data-parallel run took: Adam then steps on those in place
    of the reference's own, so the reference follows that run's
    parameters and each step's loss and gradients are held on the same
    state. (On a card B2's float atomics differ in the last bits from
    run to run, and a render's discrete choices turn that into different
    samples a few steps on.)

    Returns (the losses as floats, each step's mean gradients by name,
    the parameters by name), on the CPU."""
    world = len(seeds)
    params = list(model.parameters())
    names = {p: n for n, p in model.named_parameters()}
    opt = torch.optim.Adam(params, lr=lr)
    k = o.shape[0] // world
    gens = [torch.Generator(o.device).manual_seed(s) for s in seeds]
    losses, grads = [], []
    for it in range(1, steps + 1):
        if before_step is not None:
            before_step(it)
        opt.zero_grad(set_to_none=True)
        per, gs = [], []
        for r, g in enumerate(gens):
            loss = loss_fn(o[r * k:(r + 1) * k], d[r * k:(r + 1) * k], g)
            gs.append(torch.autograd.grad(loss, params, allow_unused=True))
            per.append(loss.detach())
        for p, *g in zip(params, *gs):
            if g[0] is not None:
                p.grad = sum(g) / world
        grads.append({names[p]: p.grad.detach().cpu().clone()
                      for p in params if p.grad is not None})
        if forced is not None:
            for p in params:
                if p.grad is not None:
                    p.grad = forced[it - 1][names[p]].to(p.device)
        opt.step()
        losses.append(float(sum(per) / world))
    return losses, grads, {n: p.detach().cpu().clone() for n, p in
                           model.named_parameters()}


def neus_reference(inp: dict, device="cpu", world: int = 2, forced=None):
    """`halves_reference` of the small NeuS on `world` ranks' halves of
    the rays, with their draws (seeds 100 + rank), for NEUS_STEPS steps.
    Returns (losses [steps], each step's gradients by name, the
    parameters by name)."""
    model = neus_model(inp["neus_table"], device)
    losses, grads, params = halves_reference(
        model, lambda o, d, g: neus_loss(model, o, d, g),
        _t(inp["neus_o"]).to(device), _t(inp["neus_d"]).to(device),
        [100 + r for r in range(world)], NEUS_STEPS, forced=forced)
    return torch.tensor(losses, dtype=torch.float32), grads, params


def neus_loss(model, o, d, generator):
    """MSE(rgb, |d|) + 0.1·eikonal over the valid packed nablas (the
    production step's loss)."""
    from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss

    rendered, vb = model.ray_query(model.ray_test(o, d), generator=generator)
    loss = torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2)
    return loss + 0.1 * eikonal_loss(vb["nablas_packed"],
                                     vb["ridx"] < o.shape[0])


def _dp(inp, out):
    from nr3d_lib_tpu_torch.parallel import make_mesh
    from nr3d_lib_tpu_torch.parallel.train import (make_sharded_train_step,
                                                   replicate, shard_rays)

    mesh = make_mesh()
    params = replicate({"w": _t(inp["dp_w"]), "b": _t(inp["dp_b"])}, mesh)
    params = {k: torch.nn.Parameter(v) for k, v in params.items()}
    opt = torch.optim.SGD(params.values(), lr=0.1)
    batch = shard_rays({"x": _t(inp["dp_x"]), "y": _t(inp["dp_y"])}, mesh)

    def loss_fn(b, generator):
        pred = b["x"] @ params["w"] + params["b"]
        return torch.mean((pred - b["y"]) ** 2)

    loss = make_sharded_train_step(loss_fn, opt, mesh)(batch)
    out["dp_loss"] = loss
    out["dp_w"] = params["w"].detach().clone()
    out["dp_b"] = params["b"].detach().clone()
    out["dp_rows"] = batch["x"].shape[0]


def _forest(inp, out, world):
    from nr3d_lib_tpu_torch.ops import lotd as L
    from nr3d_lib_tpu_torch.parallel import make_mesh
    from nr3d_lib_tpu_torch.parallel.forest_parallel import (
        forest_encode_block_sharded, make_forest_sharded_train_step,
        pad_blocks_for_sharding)
    from nr3d_lib_tpu_torch.parallel.train import shard_rays

    n_data = 2 if world == 4 else 1
    mesh = make_mesh([n_data, world // n_data], ("data", "block"))
    meta = L.generate_meta(3, [4, 6], 2, "Dense")
    n_block = mesh["block"].size()
    blocks = pad_blocks_for_sharding(_t(inp["forest_params"]), n_block)
    batch = shard_rays({"x": _t(inp["forest_x"]),
                        "bidx": _t(inp["forest_bidx"]),
                        "tgt": _t(inp["forest_tgt"])}, mesh)
    out["forest_feats"] = forest_encode_block_sharded(
        batch["x"], batch["bidx"], blocks, meta, mesh)
    out["forest_data_rank"] = mesh.get_local_rank("data")
    out["forest_block_rank"] = mesh.get_local_rank("block")
    params = {"blocks": torch.nn.Parameter(blocks.clone()),
              "other": torch.nn.Parameter(_t(inp["forest_w"]))}
    opt = torch.optim.SGD(params.values(), lr=0.5)

    def loss_fn(other, feats, b):
        return torch.mean((feats @ other - b["tgt"]) ** 2)

    step = make_forest_sharded_train_step(loss_fn, opt, meta, mesh)
    out["forest_loss"] = step(params, batch)
    k = blocks.shape[0] // n_block
    own = slice(out["forest_block_rank"] * k,
                (out["forest_block_rank"] + 1) * k)
    out["forest_grad_own"] = params["blocks"].grad[own].clone()
    out["forest_grad_other_rows"] = float(
        params["blocks"].grad.abs().sum() - params["blocks"].grad[own]
        .abs().sum())
    out["forest_blocks_own"] = params["blocks"].detach()[own].clone()
    out["forest_other"] = params["other"].detach().clone()


def _table(inp, out, world):
    from nr3d_lib_tpu_torch.ops import lotd_brick as B
    from nr3d_lib_tpu_torch.parallel import make_mesh
    from nr3d_lib_tpu_torch.parallel.table_parallel import (
        brick_encode_table_sharded, pad_table_for_sharding)

    mesh = make_mesh([1, world], ("data", "model"))
    meta = B.make_brick_meta([16, 32, 256], ["Dense", "Dense", "Hash"],
                             hashmap_rows=512)
    table = torch.nn.Parameter(pad_table_for_sharding(
        _t(inp["table"]), world))
    x = _t(inp["table_x"])
    y = brick_encode_table_sharded(x, table, meta, mesh)
    (y ** 2).sum().backward()
    out["table_y"] = y.detach()
    out["table_grad"] = table.grad


def _pipeline(inp, out, world):
    from nr3d_lib_tpu_torch.parallel import make_mesh
    from nr3d_lib_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = make_mesh([world], ("stage",))
    ws = torch.nn.Parameter(_t(inp["pipe_ws"][:world]))
    y = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws,
                       _t(inp["pipe_xs"]), mesh)
    (y ** 2).sum().backward()
    out["pipe_y"] = y.detach()
    out["pipe_grad"] = ws.grad


def _ckpt(inp, out, world, work_dir):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from nr3d_lib_tpu_torch.checkpoint_sharded import (abstract_like,
                                                       load_sharded,
                                                       save_sharded)
    from nr3d_lib_tpu_torch.parallel import make_mesh

    mesh = make_mesh([world], ("data",))
    full = _t(inp["ckpt_table"])
    state = {"blocks": distribute_tensor(full, mesh, [Shard(0)]),
             "mlp": _t(inp["ckpt_mlp"]), "it": 10}
    path = save_sharded(os.path.join(work_dir, "ckpt"), state)
    back = load_sharded(path, state)
    out["ckpt_same_local"] = back["blocks"].to_local()
    out["ckpt_same_placement"] = str(back["blocks"].placements)
    tmpl = {"blocks": distribute_tensor(torch.zeros_like(full), mesh,
                                        [Replicate()]),
            "mlp": abstract_like(state["mlp"]), "it": 0}
    re = load_sharded(path, tmpl)
    out["ckpt_replicated"] = re["blocks"].to_local()
    out["ckpt_placement"] = str(re["blocks"].placements)
    out["ckpt_mlp"] = re["mlp"]
    out["ckpt_it"] = re["it"]


def _neus(inp, out, rank, device):
    from nr3d_lib_tpu_torch.parallel import make_mesh
    from nr3d_lib_tpu_torch.parallel.train import (make_sharded_train_step,
                                                   shard_rays)

    mesh = make_mesh(device_type=torch.device(device).type)
    model = neus_model(inp["neus_table"], device)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    gen = torch.Generator(device).manual_seed(100 + rank)
    step = make_sharded_train_step(
        lambda b, g: neus_loss(model, b["o"], b["d"], g), opt, mesh)
    batch = shard_rays({"o": _t(inp["neus_o"]).to(device),
                        "d": _t(inp["neus_d"]).to(device)}, mesh)
    losses, grads = [], []
    for _ in range(NEUS_STEPS):
        losses.append(step(batch, gen))
        grads.append({k: p.grad.cpu().clone() for k, p in
                      model.named_parameters() if p.grad is not None})
    out["neus_losses"] = torch.stack(losses).cpu()
    out["neus_grads"] = grads
    out["neus_params"] = {k: p.detach().cpu()
                          for k, p in model.named_parameters()}
    out["neus_occ"] = model.accel.occ.val_grid.cpu()


def _join(rank: int, world: int, work_dir: str, device: str) -> dict:
    """Join the group through `work_dir/init`, with a 60 s timeout. On the
    CPU as a torchrun process does: its variables set, then
    `parallel.init_env`. Ranks that share a card join gloo by hand
    (`init_env` takes NCCL where there is a card, and NCCL refuses two
    ranks on one device)."""
    from nr3d_lib_tpu_torch import parallel

    url = "file://" + os.path.join(work_dir, "init")
    parallel._TIMEOUT = datetime.timedelta(seconds=60)
    if device != "cpu":
        dist.init_process_group("gloo", init_method=url, rank=rank,
                                world_size=world, timeout=parallel._TIMEOUT)
        return {}
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    parallel.init_env(seed=7, coordinator_address=url)
    return {"env": (parallel.rank(), parallel.world_size(),
                    parallel.local_rank(), parallel.is_master(),
                    dist.get_backend()),
            "env_draw": float(torch.rand(()))}


def run(rank: int, world: int, work_dir: str, device: str = "cpu") -> None:
    """Every check on the CPU; on a card (`device="cuda"`: the ranks share
    cuda:0, gloo moving its tensors) the NeuS step alone."""
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(work_dir, "inputs.pt"), weights_only=False)
    out = _join(rank, world, work_dir, device)
    try:
        if device == "cpu":
            _dp(inp, out)
            _forest(inp, out, world)
            _table(inp, out, world)
            _pipeline(inp, out, world)
            _ckpt(inp, out, world, work_dir)
        if world == 2:
            _neus(inp, out, rank, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(work_dir, f"rank{rank}.pt"))
