"""Train a LoTD NeRF on an analytic scene and render a turntable, on the
port (the counterpart of examples/train_nerf_synthetic.py).

The "dataset" is an analytic normal-coloured sphere, or with --scene
hard the NeRF-synthetic stand-in (five textured spheres and a checkered
ground, PSNR on held-out views):

    python examples_torch/train_nerf_synthetic.py --iters 500 --out /tmp/nerf_run

Runs on the CUDA card, or on the CPU with --cpu.
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from examples_torch import common
from examples_torch.common import Trainer, default_out, device_of, generator

N_SAMPLES = 64
SPH_C = [[0.0, 0.0, 0.0], [0.45, 0.3, -0.15], [-0.45, -0.2, 0.1],
         [0.15, -0.45, -0.25], [-0.2, 0.45, 0.3]]
SPH_R = [0.28, 0.18, 0.2, 0.14, 0.12]
SPH_F = [[9.0, 5.0, 13.0], [17.0, 11.0, 6.0], [7.0, 15.0, 9.0],
         [21.0, 8.0, 12.0], [11.0, 19.0, 7.0]]

# what a run writes under --out, as the JAX script does
OUTPUTS = ["scalars.jsonl", "ckpts/ckpt_final.pt"] + \
    [f"turntable/frame_{i:04d}.png" for i in range(8)]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--out", type=str, default=default_out("nerf_run"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--brick", action="store_true",
                    help="use the brick encoding backend")
    ap.add_argument("--w4", action="store_true",
                    help="F=4 brick levels (implies --brick)")
    ap.add_argument("--scene", choices=["sphere", "hard"], default="sphere",
                    help="'hard': the NeRF-synthetic stand-in, PSNR on "
                         "held-out views")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="held-out-view PSNR every N iters; default: only "
                         "at the end")
    return ap.parse_args(argv)


# ---------------------------------------------------------- analytic scenes
def scene_sphere(o, d):
    b = torch.sum(o * d, -1)
    c = torch.sum(o * o, -1) - 0.25
    disc = b * b - c
    hit = disc > 0
    p = o + d * (-b - torch.sqrt(torch.clamp(disc, min=0.0)))[:, None]
    n = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-9)
    return torch.where(hit[:, None], n * 0.5 + 0.5, 0.0)


def scene_hard(o, d):
    """Five striped spheres and an 8×8-checkered ground plane z = −0.48."""
    dev = o.device
    sph_c = torch.tensor(SPH_C, device=dev)
    sph_r = torch.tensor(SPH_R, device=dev)
    oc = o[:, None, :] - sph_c[None]
    b = torch.sum(oc * d[:, None, :], -1)
    c = torch.sum(oc * oc, -1) - sph_r[None] ** 2
    disc = b * b - c
    t_sph = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t_sph = torch.where((disc > 0) & (t_sph > 1e-3), t_sph, math.inf)
    tz = (-0.48 - o[:, 2]) / torch.where(torch.abs(d[:, 2]) < 1e-6, 1e-6,
                                         d[:, 2])
    pz = o + d * tz[:, None]
    on_plane = (tz > 1e-3) & (torch.abs(pz[:, 0]) < 1.0) \
        & (torch.abs(pz[:, 1]) < 1.0)
    tz = torch.where(on_plane, tz, math.inf)
    t_all = torch.cat([t_sph, tz[:, None]], -1)
    t, k = torch.min(t_all, -1)
    hit = torch.isfinite(t)
    p = o + d * torch.where(hit, t, 0.0)[:, None]
    f = torch.cat([torch.tensor(SPH_F, device=dev),
                   torch.zeros((1, 3), device=dev)], 0)[k]
    tex_sph = 0.5 + 0.5 * torch.sin(f * p + torch.tensor([0.0, 2.1, 4.2],
                                                         device=dev))
    checker = (torch.floor(p[:, 0] * 4) + torch.floor(p[:, 1] * 4)) % 2
    tex_pln = torch.stack([0.15 + 0.7 * checker] * 3, -1)
    rgb = torch.where((k == 5)[:, None], tex_pln, tex_sph)
    return torch.where(hit[:, None], rgb, 0.0)


def make_sampler(scene, tgt_half: float):
    def sample_rays(n: int, gen: torch.Generator):
        dev = gen.device
        o = torch.randn((n, 3), generator=gen, device=dev)
        r_o = torch.rand((n, 1), generator=gen, device=dev) * 0.8 + 1.8
        o = o / torch.linalg.norm(o, dim=-1, keepdim=True) * r_o
        tgt = (torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0) \
            * tgt_half
        d = tgt - o
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return {"o": o, "d": d, "rgb": scene(o, d)}
    return sample_rays


def heldout_views(device, n_views: int = 4, hw: int = 96):
    """Held-out cameras: a fixed ring at radius 2.4, at elevations the
    training distribution does not privilege."""
    from nr3d_lib_tpu_torch.graphics.cameras import (look_at, pixel_grid,
                                                     pinhole_get_rays)

    intr = torch.tensor([[hw * 1.2, 0, hw / 2], [0, hw * 1.2, hw / 2],
                         [0, 0, 1.0]], device=device)
    uv = pixel_grid(hw, hw, device=device).reshape(-1, 2)
    views = []
    for i in range(n_views):
        az = 2 * math.pi * (i + 0.5) / n_views
        eye = [2.4 * math.cos(az) * 0.9, 2.4 * math.sin(az) * 0.9, 1.0]
        c2w = look_at(eye, [0.0, 0.0, -0.1], device=device)
        views.append(pinhole_get_rays(uv, intr, c2w))
    return views


# ------------------------------------------------------------------- model
def model_cfg(args) -> dict:
    enc_cfg = {"lotd_cfg": {"lod_res": [16, 32, 64], "lod_n_feats": 2,
                            "lod_types": ["Dense", "Dense", "Hash"],
                            "hashmap_size": 2 ** 14}}
    if args.w4:
        # the same 6 output features from half the levels
        enc_cfg = {"lotd_cfg": {"lod_res": [16, 48], "lod_n_feats": 4,
                                "lod_types": ["Dense", "Hash"],
                                "hashmap_size": 2 ** 14},
                   "backend": "brick"}
    elif args.brick:
        enc_cfg["backend"] = "brick"
    return dict(field_cfg={"encoding_cfg": enc_cfg,
                           "density_decoder_cfg": {"D": 1, "W": 64},
                           "radiance_cfg": {"D": 2, "W": 64}})


def render_fixed(model, o, d, gen=None):
    from nr3d_lib_tpu_torch.graphics.nerf_ray_query import \
        nerf_ray_query_fixed
    from nr3d_lib_tpu_torch.graphics.raysample import uniform_draw

    rendered, _ = nerf_ray_query_fixed(
        model, model.space, model.space.ray_test(o, d), n_samples=N_SAMPLES,
        draw=None if gen is None else uniform_draw(gen))
    return rendered


def setup(args) -> Trainer:
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeRFModel

    model = LoTDNeRFModel(**model_cfg(args), seed=common.SEED_SHIFT,
                          device=device_of(args))
    model.populate()
    scene = scene_hard if args.scene == "hard" else scene_sphere
    # the hard scene fills the unit box: training rays must cover it
    sample = make_sampler(scene, 0.7 if args.scene == "hard" else 0.3)

    def loss_fn(m, b, gen):
        rendered = render_fixed(m, b["o"], b["d"], gen)
        return torch.mean((rendered["rgb_volume"] - b["rgb"]) ** 2), None

    # the JAX script's loop runs no lifecycle hook
    tr = Trainer(model, loss_fn, sample, lr=5e-3, rays=args.rays,
                 lifecycle_seed=False)
    tr.scene = scene
    return tr


@torch.no_grad()
def evaluate(tr) -> float:
    from nr3d_lib_tpu_torch.graphics.metrics import psnr

    b = tr.sample(2048, generator(tr.model.device, 123))
    return float(psnr(render_fixed(tr.model, b["o"], b["d"])["rgb_volume"],
                      b["rgb"]))


@torch.no_grad()
def eval_heldout(tr, views) -> float:
    from nr3d_lib_tpu_torch.graphics.metrics import psnr

    vals = [float(psnr(render_fixed(tr.model, o, d)["rgb_volume"],
                       tr.scene(o, d))) for o, d in views]
    return sum(vals) / len(vals)


def main(argv=None) -> dict:
    from nr3d_lib_tpu_torch.gui import render_turntable
    from nr3d_lib_tpu_torch.logger import Logger

    args = parse(argv)
    tr = setup(args)
    model = tr.model
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = tr.checkpoint_io(os.path.join(args.out, "ckpts"))
    views = heldout_views(model.device) if args.scene == "hard" else None
    psnr0 = evaluate(tr)
    print(f"val PSNR before training: {psnr0:.2f} dB")

    def on_step(it):
        if views is not None and args.eval_every \
                and it % args.eval_every == 0:
            p_ho = eval_heldout(tr, views)
            logger.add("val", "psnr_heldout", p_ho, it)
            print(f"it {it:5d}  held-out PSNR {p_ho:.2f} dB")

    res = tr.train(args.iters, logger, log_rgb=False, on_step=on_step)
    val_psnr = evaluate(tr)
    print(f"val PSNR: {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    out = dict(res, psnr=val_psnr, psnr_init=psnr0)
    if views is not None:
        p_ho = eval_heldout(tr, views)
        logger.add("val", "psnr_heldout", p_ho, args.iters)
        print(f"held-out-view PSNR ({args.scene}): {p_ho:.2f} dB")
        out["psnr_heldout"] = p_ho

    ckpt.save("ckpt_final.pt", it=args.iters, psnr=val_psnr)
    # refresh the occupancy grid from the trained density so the
    # turntable's marched query skips empty space
    with torch.no_grad():
        model.accel.occ.init_from_net(model.query_density)
    model.accel.occ.occ_thre = 1.0
    frames = render_turntable(model, n_frames=8, radius=2.5, hw=(128, 128),
                              out_dir=os.path.join(args.out, "turntable"))
    print(f"wrote checkpoint + {len(frames)} turntable frames to {args.out}")
    logger.close()
    return out


if __name__ == "__main__":
    main()
