"""EmerNeRF-style dynamic scene on the port — static/dynamic
decomposition (the counterpart of examples/train_dynamic_scene.py).

`EmerNeRFModel` trained on an analytic scene — a static checkerboard
floor and a sphere oscillating along x — then evaluated, checkpointed,
and rendered as full / static-only / dynamic-only frames at two times:

    python examples_torch/train_dynamic_scene.py --iters 600 --out /tmp/dyn_run

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

# what a run writes under --out, as the JAX script does
OUTPUTS = ["scalars.jsonl", "ckpts/ckpt_final.pt"] + [
    f"{k}_t{t:+.1f}.png" for t in (-0.5, 0.5)
    for k in ("rgb", "rgb_static", "rgb_dynamic", "gt")]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--out", type=str, default=default_out("dyn_run"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--hw", type=int, default=96, help="eval frame size")
    return ap.parse_args(argv)


# ------------------------------------------------------- analytic scene
def sphere_center(ts):
    return torch.stack([0.45 * torch.sin(math.pi * ts),
                        torch.zeros_like(ts), torch.zeros_like(ts)], -1)


def trace_gt(o, d, ts):
    """Static: a checkerboard floor at y = −0.4; dynamic: a sphere sliding
    along x."""
    dev = o.device
    c = sphere_center(ts)
    oc = o - c
    b = torch.sum(oc * d, -1)
    disc = b * b - (torch.sum(oc * oc, -1) - 0.3 ** 2)
    t_sph = torch.where(disc > 0, -b - torch.sqrt(torch.clamp(disc, min=0.0)),
                        math.inf)
    t_sph = torch.where(t_sph > 1e-3, t_sph, math.inf)
    p_sph = o + t_sph[:, None] * d
    n = p_sph - c
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    rgb_sph = torch.clamp(n * 0.5 + 0.5, 0, 1) * torch.tensor(
        [1.0, 0.7, 0.5], device=dev)

    t_pl = (-0.4 - o[:, 1]) / torch.where(torch.abs(d[:, 1]) < 1e-6, 1e-6,
                                          d[:, 1])
    p_pl = o + t_pl[:, None] * d
    on_pl = ((t_pl > 1e-3) & (torch.abs(p_pl[:, 0]) < 0.9)
             & (torch.abs(p_pl[:, 2]) < 0.9))
    t_pl = torch.where(on_pl, t_pl, math.inf)
    check = (torch.floor(p_pl[:, 0] * 5) + torch.floor(p_pl[:, 2] * 5)) % 2
    rgb_pl = torch.where(check[:, None] > 0.5,
                         torch.tensor([0.8, 0.8, 0.85], device=dev),
                         torch.tensor([0.25, 0.3, 0.35], device=dev))

    rgb = torch.zeros_like(o)
    rgb = torch.where((t_pl < t_sph)[:, None], rgb_pl, rgb)
    return torch.where((t_sph <= t_pl)[:, None]
                       & torch.isfinite(t_sph)[:, None], rgb_sph, rgb)


def sample_rays(n: int, gen: torch.Generator):
    dev = gen.device
    o = torch.randn((n, 3), generator=gen, device=dev)
    o[:, 1] = torch.abs(o[:, 1]) * 0.5 + 0.2          # stay above the floor
    o = o / torch.linalg.norm(o, dim=-1, keepdim=True) * 2.0
    tgt = torch.rand((n, 3), generator=gen, device=dev) * 0.6 - 0.3
    d = tgt - o
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    ts = torch.rand((n,), generator=gen, device=dev) * 2.0 - 1.0
    return {"o": o, "d": d, "ts": ts, "rgb": trace_gt(o, d, ts)}


MODEL_CFG = dict(
    field_cfg={"static_cfg": {"lotd_cfg": {
        "lod_res": [16, 32, 64], "lod_n_feats": 2,
        "lod_types": ["Dense", "Dense", "Hash"], "hashmap_size": 2 ** 15}},
        "dynamic_permuto_cfg": {"res_list": [8.0, 16.0, 32.0], "n_feats": 2,
                                "log2_hashmap_size": 15}},
    accel_cfg={"resolution": (16, 16, 16)}, n_time_keys=8, n_march_steps=64)


def tested(model, b):
    rt = model.ray_test(b["o"], b["d"])
    rt["ts"] = b["ts"]
    return rt


def setup(args) -> Trainer:
    from nr3d_lib_tpu_torch.models.model_families import EmerNeRFModel

    model = EmerNeRFModel(**MODEL_CFG, seed=common.SEED_SHIFT,
                          device=device_of(args))
    model.populate()

    def loss_fn(m, b, gen):
        rendered, vb = m.ray_query(tested(m, b), generator=gen)
        rgb_l = torch.mean((rendered["rgb_volume"] - b["rgb"]) ** 2)
        # the reference's per-step regularizers, from the volume buffer
        reg = (1e-3 * vb["reg_dynamic_sparsity"]
               + 1e-4 * vb.get("reg_flow_smooth", 0.0)
               + 1e-4 * vb.get("reg_flow_cycle", 0.0)
               + 1e-4 * vb.get("reg_shadow", 0.0))
        return rgb_l + reg, rgb_l

    return Trainer(model, loss_fn, sample_rays, lr=4e-3, rays=args.rays,
                   lifecycle_seed=5000)


@torch.no_grad()
def evaluate(model) -> float:
    from nr3d_lib_tpu_torch.graphics.metrics import psnr

    b = sample_rays(2048, generator(model.device, 123))
    rendered, _ = model.ray_query(tested(model, b))
    return float(psnr(rendered["rgb_volume"], b["rgb"]))


def eval_camera(hw: int, device):
    """The frames' camera: rays [hw², 3] (origins, directions)."""
    from nr3d_lib_tpu_torch.graphics.cameras import (look_at, pixel_grid,
                                                     pinhole_get_rays)

    intr = torch.tensor([[hw * 0.9, 0, hw / 2], [0, hw * 0.9, hw / 2],
                         [0, 0, 1]], device=device)
    c2w = look_at(eye=(1.4, 1.0, 1.4), target=(0.0, -0.1, 0.0),
                  device=device)
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
    print(f"val PSNR (random rays/times): {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    ckpt.save("ckpt_final.pt", it=args.iters, psnr=val_psnr)

    # full / static / dynamic frames at two times
    h = w = args.hw
    o_img, d_img = eval_camera(h, model.device)
    for t_val in (-0.5, 0.5):
        ts = torch.full((h * w,), t_val, device=model.device)
        with torch.no_grad():
            rendered, _ = model.ray_query(tested(
                model, {"o": o_img, "d": d_img, "ts": ts}))
        for k in ("rgb_volume", "rgb_static_volume", "rgb_dynamic_volume"):
            save_image(os.path.join(
                args.out, f"{k.replace('_volume', '')}_t{t_val:+.1f}.png"),
                rendered[k].reshape(h, w, 3))
        save_image(os.path.join(args.out, f"gt_t{t_val:+.1f}.png"),
                   trace_gt(o_img, d_img, ts).reshape(h, w, 3))
    print(f"wrote checkpoint + decomposition frames to {args.out}")
    logger.close()
    return dict(res, psnr=val_psnr, psnr_init=psnr0)


if __name__ == "__main__":
    main()
