"""Conditional + dynamic shapes on the port — N pulsating shapes, one
model (the counterpart of examples/train_conditional_dynamic.py).

A single `DynamicGenerativeNeuSModel`, conditioned on an instance latent
and on time, fits three ellipsoids whose half-axes pulse over time, each
with its own phase, then renders an (instance × time) frame grid:

    python examples_torch/train_conditional_dynamic.py --iters 600 --out /tmp/cd_run

Runs on the CUDA card, or on the CPU with --cpu.
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch import common
from examples_torch.common import Trainer, default_out, device_of
from examples_torch.train_generative_shapes import (eval_camera, evaluate,
                                                    latent_loss, tested,
                                                    trace_ellipsoids)

AXES = np.asarray([[0.45, 0.35, 0.35],
                   [0.30, 0.50, 0.30],
                   [0.38, 0.38, 0.38]], np.float32)
PHASES = np.asarray([0.0, 2.1, 4.2], np.float32)
N_INST = len(AXES)

# what a run writes under --out, as the JAX script does
OUTPUTS = ["scalars.jsonl", "ckpts/ckpt_final.pt",
           "instance_time_grid.png"]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--out", type=str, default=default_out("cd_run"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--hw", type=int, default=64, help="eval frame size")
    return ap.parse_args(argv)


def axes_t(bidx, ts):
    dev = ts.device
    pulse = 1.0 + 0.25 * torch.sin(math.pi * ts
                                   + torch.from_numpy(PHASES).to(dev)[bidx])
    return torch.from_numpy(AXES).to(dev)[bidx] * pulse[:, None]


def trace_gt(o, d, bidx, ts):
    return trace_ellipsoids(o, d, axes_t(bidx, ts))


def sample_rays(n: int, gen: torch.Generator):
    dev = gen.device
    o = torch.randn((n, 3), generator=gen, device=dev)
    o = o / torch.linalg.norm(o, dim=-1, keepdim=True) * 2.0
    tgt = torch.rand((n, 3), generator=gen, device=dev) * 0.4 - 0.2
    d = tgt - o
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    bidx = torch.randint(0, N_INST, (n,), generator=gen, device=dev)
    ts = torch.rand((n,), generator=gen, device=dev) * 2.0 - 1.0
    return {"o": o, "d": d, "bidx": bidx, "ts": ts,
            "rgb": trace_gt(o, d, bidx, ts)}


MODEL_CFG = dict(
    n_instances=N_INST, latent_dim=4, latent_std=0.1,
    field_cfg={"surface_cfg": {
        "permuto_cfg": {"res_list": [8.0, 16.0, 32.0], "n_feats": 2,
                        "log2_hashmap_size": 15},
        "decoder_cfg": {"D": 1, "W": 64}},
        "radiance_cfg": {"D": 2, "W": 64},
        "var_ctrl_cfg": {"type": "learned", "init_val": 64.0}},
    ray_query_cfg={"n_coarse": 32, "upsample_inv_s_factors": [1.0, 4.0],
                   "n_importance": 8})


def setup(args) -> Trainer:
    from nr3d_lib_tpu_torch.models.model_families import \
        DynamicGenerativeNeuSModel

    model = DynamicGenerativeNeuSModel(**MODEL_CFG, seed=common.SEED_SHIFT,
                                       device=device_of(args))
    return Trainer(model, latent_loss, sample_rays, lr=3e-3, rays=args.rays,
                   clip=5.0)


def main(argv=None) -> dict:
    from nr3d_lib_tpu_torch.logger import Logger
    from nr3d_lib_tpu_torch.plot import gallery
    from nr3d_lib_tpu_torch.utils import save_image, to_numpy

    args = parse(argv)
    tr = setup(args)
    model = tr.model
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = tr.checkpoint_io(os.path.join(args.out, "ckpts"))
    psnr0 = evaluate(model, sample_rays)
    print(f"val PSNR before training: {psnr0:.2f} dB")
    res = tr.train(args.iters, logger)

    val_psnr = evaluate(model, sample_rays)
    print(f"val PSNR (random rays/instances/times): {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    ckpt.save("ckpt_final.pt", it=args.iters, psnr=val_psnr)

    # (instance × time) frame grid: both conditions scrubbed at once
    h = w = args.hw
    dev = model.device
    o_img, d_img = eval_camera(h, dev)
    frames = []
    for i in range(N_INST):
        for t_val in (-0.5, 0.0, 0.5):
            b = {"o": o_img, "d": d_img,
                 "bidx": torch.full((h * w,), i, dtype=torch.int32,
                                    device=dev),
                 "ts": torch.full((h * w,), t_val, device=dev)}
            with torch.no_grad():
                rendered, _ = model.ray_query(tested(model, b))
            frames.append(to_numpy(rendered["rgb_volume"]).reshape(h, w, 3))
    save_image(os.path.join(args.out, "instance_time_grid.png"),
               gallery(np.stack(frames), ncols=3))
    print(f"wrote checkpoint + instance x time grid to {args.out}")
    logger.close()
    return dict(res, psnr=val_psnr, psnr_init=psnr0)


if __name__ == "__main__":
    main()
