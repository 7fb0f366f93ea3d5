"""Generative shapes on the port — one latent-conditioned NeuS for a
category of objects (the counterpart of examples/train_generative_shapes.py).

A single `GenerativePermutoNeuSModelBatched` (per-instance latents and a
shared generative-permuto NeuS) fits four analytic ellipsoids, then
renders each instance and an interpolation in latent space between two:

    python examples_torch/train_generative_shapes.py --iters 600 --out /tmp/gen_run

Runs on the CUDA card, or on the CPU with --cpu.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch import common
from examples_torch.common import Trainer, default_out, device_of, generator

# the "category": per-instance ellipsoid half-axes
AXES = np.asarray([[0.45, 0.45, 0.45],
                   [0.55, 0.30, 0.30],
                   [0.30, 0.55, 0.30],
                   [0.35, 0.35, 0.60]], np.float32)
N_INST = len(AXES)

# what a run writes under --out, as the JAX script does
OUTPUTS = ["scalars.jsonl", "ckpts/ckpt_final.pt"] + [
    f"{k}_{i}.png" for i in range(4) for k in ("instance", "gt")] + [
    f"interp_{j}_a{a:.2f}.png" for j, a in enumerate((0.25, 0.5, 0.75))]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--out", type=str, default=default_out("gen_run"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--hw", type=int, default=80, help="eval frame size")
    return ap.parse_args(argv)


# ------------------------------------------------------- analytic scene
def ellipsoid_sdf(p, a):
    """(|p/a| − 1)·min(a): a bound of the ellipsoid's SDF, exact for a
    sphere."""
    return (torch.linalg.norm(p / a, dim=-1) - 1.0) * torch.amin(a, dim=-1)


def trace_ellipsoids(o, d, a, n_steps: int = 64):
    """Sphere-trace the ellipsoids of half-axes a [N,3] → normal-coloured
    ground truth."""
    t = torch.full(o.shape[:1], 1.0, device=o.device)
    for _ in range(n_steps):
        t = t + ellipsoid_sdf(o + t[:, None] * d, a)
    t = torch.clamp(t, 0.0, 4.0)
    p = o + t[:, None] * d
    hit = torch.abs(ellipsoid_sdf(p, a)) < 1e-3
    n = p / (a ** 2)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    return torch.where(hit[:, None], n * 0.5 + 0.5, 0.0)


def trace_gt(o, d, bidx):
    return trace_ellipsoids(o, d, torch.from_numpy(AXES).to(o.device)[bidx])


def sample_rays(n: int, gen: torch.Generator):
    dev = gen.device
    o = torch.randn((n, 3), generator=gen, device=dev)
    o = o / torch.linalg.norm(o, dim=-1, keepdim=True) * 2.0
    tgt = torch.rand((n, 3), generator=gen, device=dev) * 0.4 - 0.2
    d = tgt - o
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    bidx = torch.randint(0, N_INST, (n,), generator=gen, device=dev)
    return {"o": o, "d": d, "bidx": bidx, "rgb": trace_gt(o, d, bidx)}


MODEL_CFG = dict(
    n_instances=N_INST, latent_dim=4, latent_std=0.1,
    field_cfg={"surface_cfg": {
        "permuto_cfg": {"res_list": [8.0, 16.0, 32.0, 64.0],
                        "n_feats": 2, "log2_hashmap_size": 15},
        "decoder_cfg": {"D": 1, "W": 64}},
        "radiance_cfg": {"D": 2, "W": 64},
        "var_ctrl_cfg": {"type": "learned", "init_val": 64.0}},
    ray_query_cfg={"n_coarse": 32, "upsample_inv_s_factors": [1.0, 4.0],
                   "n_importance": 8})


def tested(model, b):
    rt = model.ray_test(b["o"], b["d"])
    for k in ("bidx", "ts"):
        if k in b:
            rt[k] = b[k]
    return rt


def latent_loss(m, b, gen):
    """MSE + 0.03·eikonal + 1e-4·the latents' mean square (the
    autodecoder's prior, DeepSDF-style)."""
    rendered, vb = m.ray_query(tested(m, b), generator=gen)
    rgb_l = torch.mean((rendered["rgb_volume"] - b["rgb"]) ** 2)
    nab = vb.get("nablas_packed", vb.get("nablas"))
    eik = torch.mean((torch.linalg.norm(nab, dim=-1) - 1.0) ** 2)
    z = m.autodecoder.get_latent(torch.arange(m.n_instances,
                                              device=m.device))
    return rgb_l + 0.03 * eik + 1e-4 * torch.mean(z ** 2), rgb_l


def setup(args) -> Trainer:
    from nr3d_lib_tpu_torch.models.model_families import \
        GenerativePermutoNeuSModelBatched

    model = GenerativePermutoNeuSModelBatched(
        **MODEL_CFG, seed=common.SEED_SHIFT, device=device_of(args))
    # clipped: NeuS spikes as inv_s sharpens
    return Trainer(model, latent_loss, sample_rays, lr=3e-3, rays=args.rays,
                   clip=5.0)


@torch.no_grad()
def evaluate(model, sample=sample_rays) -> float:
    from nr3d_lib_tpu_torch.graphics.metrics import psnr

    b = sample(2048, generator(model.device, 123))
    rendered, _ = model.ray_query(tested(model, b))
    return float(psnr(rendered["rgb_volume"], b["rgb"]))


def eval_camera(hw: int, device):
    from nr3d_lib_tpu_torch.graphics.cameras import (look_at, pixel_grid,
                                                     pinhole_get_rays)

    intr = torch.tensor([[hw * 0.9, 0, hw / 2], [0, hw * 0.9, hw / 2],
                         [0, 0, 1]], device=device)
    c2w = look_at(eye=(1.3, 1.1, 1.3), target=(0.0, 0.0, 0.0), device=device)
    return pinhole_get_rays(pixel_grid(hw, hw, device=device).reshape(-1, 2),
                            intr, c2w)


def main(argv=None) -> dict:
    from nr3d_lib_tpu_torch.logger import Logger
    from nr3d_lib_tpu_torch.utils import save_image

    args = parse(argv)
    tr = setup(args)
    model = tr.model
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = tr.checkpoint_io(os.path.join(args.out, "ckpts"))
    psnr0 = evaluate(model)
    print(f"val PSNR before training: {psnr0:.2f} dB")
    res = tr.train(args.iters, logger)

    val_psnr = evaluate(model)
    print(f"val PSNR (random rays/instances): {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    ckpt.save("ckpt_final.pt", it=args.iters, psnr=val_psnr)

    h = w = args.hw
    dev = model.device
    o_img, d_img = eval_camera(h, dev)

    @torch.no_grad()
    def render_frame(inst):
        bidx = torch.full((h * w,), inst, dtype=torch.int32, device=dev)
        rendered, _ = model.ray_query(tested(
            model, {"o": o_img, "d": d_img, "bidx": bidx}))
        return rendered["rgb_volume"].reshape(h, w, 3)

    for i in range(N_INST):
        save_image(os.path.join(args.out, f"instance_{i}.png"),
                   render_frame(i))
        gt = trace_gt(o_img, d_img, torch.full((h * w,), i, device=dev))
        save_image(os.path.join(args.out, f"gt_{i}.png"), gt.reshape(h, w, 3))

    # interpolate latents 0→1 by writing blends into instance 0's row
    weight = model.autodecoder.latents.weight
    z_all = weight.detach().clone()
    with torch.no_grad():
        for j, alpha in enumerate((0.25, 0.5, 0.75)):
            weight[0] = (1 - alpha) * z_all[0] + alpha * z_all[1]
            save_image(os.path.join(args.out,
                                    f"interp_{j}_a{alpha:.2f}.png"),
                       render_frame(0))
        weight.copy_(z_all)   # restore
    print(f"wrote checkpoint, per-instance + interpolation frames to "
          f"{args.out}")
    logger.close()
    return dict(res, psnr=val_psnr, psnr_init=psnr0)


if __name__ == "__main__":
    main()
