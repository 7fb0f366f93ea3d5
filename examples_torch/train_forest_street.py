"""Street-scale forest training on the port (the counterpart of
examples/train_forest_street.py).

`LoTDForestNeuSModel` — per-block LoTD tables, per-block occupancy,
segment ray marching — trained on an analytic "street": a ground plane
and a row of spheres down a corridor of 6×1×1 blocks, supervised by
ray-cast RGB; then evaluated, checkpointed, and rendered along the
street:

    python examples_torch/train_forest_street.py --iters 400 --out /tmp/forest_run

Runs on the CUDA card, or on the CPU with --cpu. The model trains in
place, so the evaluation, the checkpoint, the occupancy line and the
fly-through use the occupancy grids as training left them.
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch import common
from examples_torch.common import Trainer, default_out, device_of, generator

CENTERS = [[x, -0.05, 0.0] for x in (-2.5, -0.5, 1.5)]
R = 0.28
GROUND_Y = -0.3

# what a run writes under --out, as the JAX script does
OUTPUTS = ["scalars.jsonl", "ckpts/ckpt_final.pt"] + \
    [f"flythrough/{i:02d}.png" for i in range(6)]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--out", type=str, default=default_out("forest_run"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--march", choices=("fixed", "segments"),
                    default="segments")
    ap.add_argument("--brick", action="store_true",
                    help="per-block brick tables")
    return ap.parse_args(argv)


def scene(o, d):
    """First-hit RGB of the analytic street (plane + spheres)."""
    t_best = torch.full(o.shape[:1], 1e9, device=o.device)
    rgb = torch.zeros_like(o)
    for c in CENTERS:
        c = torch.tensor(c, device=o.device)
        oc = o - c
        b = torch.sum(oc * d, -1)
        cc = torch.sum(oc * oc, -1) - R * R
        disc = b * b - cc
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (t > 1e-3) & (t < t_best)
        p = o + d * t[:, None]
        n = (p - c) / R
        rgb = torch.where(hit[:, None], n * 0.5 + 0.5, rgb)
        t_best = torch.where(hit, t, t_best)
    # the ground: a smooth warm gradient along the street
    t_g = (GROUND_Y - o[:, 1]) / torch.where(torch.abs(d[:, 1]) < 1e-6,
                                             1e-6, d[:, 1])
    p_g = o + d * t_g[:, None]
    shade = 0.35 + 0.3 * torch.sin(p_g[:, 0] * 0.9)
    g_rgb = torch.stack([shade + 0.15, shade, shade - 0.1], -1)
    hit_g = (t_g > 1e-3) & (t_g < t_best)
    return torch.where(hit_g[:, None], torch.clamp(g_rgb, 0, 1), rgb)


def _normal_of(f):
    """The normal quantile that `jax.random.normal` gives for the key whose
    `jax.random.uniform` bits make f in [0, 1): √2·erfinv of f mapped to
    [nextafter(−1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return math.sqrt(2.0) * torch.erfinv(f * (1.0 - lo) + lo)


def sample_rays(n: int, gen: torch.Generator):
    """Cameras hovering over the street looking down the corridor, drawn
    as the JAX script draws them: it reuses its keys, so the target's x
    offset is the normal quantile of the uniform that placed the eye's x,
    and its z offset that of the eye's height (a ray from the street's
    right end looks further right)."""
    dev = gen.device
    f1, f2, f3 = (torch.rand((n,), generator=gen, device=dev)
                  for _ in range(3))
    eye_x = f1 * 5.6 - 2.8
    o = torch.stack([eye_x, f2 * 0.25 + 0.2, f3 * 0.9 - 0.45], -1)
    tgt = torch.stack([eye_x + _normal_of(f1) * 1.5,
                       torch.full((n,), -0.25, device=dev),
                       _normal_of(f2) * 0.3], -1)
    d = tgt - o
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return {"o": o, "d": d, "rgb": scene(o, d)}


def model_cfg(args) -> dict:
    return dict(
        space_cfg={"resolution": (6, 1, 1), "origin": (-3.0, -0.5, -0.5),
                   "block_size": 1.0},
        field_cfg={"surface_cfg": {
            "lotd_cfg": {"lod_res": [8, 16, 32], "lod_n_feats": 2,
                         "lod_types": ["Dense", "Dense", "Dense"],
                         **({"backend": "brick"} if args.brick else {})},
            "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 1, "W": 64}},
        n_march_steps=128, march_mode=args.march,
        max_segments=8, steps_per_segment=24, n_importance=8)


def setup(args) -> Trainer:
    from nr3d_lib_tpu_torch.models.fields_forest import LoTDForestNeuSModel

    model = LoTDForestNeuSModel(**model_cfg(args),
                                seed=common.SEED_SHIFT,
                                device=device_of(args))
    model.populate()

    def loss_fn(m, b, gen):
        rendered, vb = m.ray_query(m.ray_test(b["o"], b["d"]), generator=gen)
        eik = torch.mean((torch.linalg.norm(vb["nablas_packed"], dim=-1)
                          - 1.0) ** 2)
        rgb_l = torch.mean((rendered["rgb_volume"] - b["rgb"]) ** 2)
        return rgb_l + 0.01 * eik, rgb_l

    return Trainer(model, loss_fn, sample_rays, lr=1e-2, rays=args.rays,
                   lifecycle_seed=7000)


@torch.no_grad()
def evaluate(model) -> float:
    from nr3d_lib_tpu_torch.graphics.metrics import psnr

    b = sample_rays(2048, generator(model.device, 123))
    rendered, _ = model.ray_query(model.ray_test(b["o"], b["d"]))
    return float(psnr(rendered["rgb_volume"], b["rgb"]))


def main(argv=None) -> dict:
    from nr3d_lib_tpu_torch.graphics.cameras import look_at
    from nr3d_lib_tpu_torch.gui import NeuralRenderer
    from nr3d_lib_tpu_torch.logger import Logger, _write_png
    from nr3d_lib_tpu_torch.utils import img_to_uint8

    args = parse(argv)
    tr = setup(args)
    model = tr.model
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = tr.checkpoint_io(os.path.join(args.out, "ckpts"))
    psnr0 = evaluate(model)
    print(f"val PSNR before training: {psnr0:.2f} dB")
    res = tr.train(args.iters, logger)

    val_psnr = evaluate(model)
    print(f"val PSNR: {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    ckpt.save("ckpt_final.pt", it=args.iters, psnr=val_psnr)

    # occupancy skipping at work: occupied share of the per-block grids
    occ = (model.accel.occ.val_grid > model.accel.occ.occ_thre).cpu().numpy()
    print(f"occupancy: {occ.mean():.1%} of cells occupied "
          f"across {occ.shape[0]} blocks")

    renderer = NeuralRenderer(model, hw=(96, 128))
    os.makedirs(os.path.join(args.out, "flythrough"), exist_ok=True)
    for i, ex in enumerate(np.linspace(-2.6, 2.0, 6)):
        c2w = look_at([ex, 0.35, 0.0], [ex + 1.2, -0.2, 0.0],
                      device=model.device)
        images = renderer.render(c2w)
        _write_png(os.path.join(args.out, "flythrough", f"{i:02d}.png"),
                   img_to_uint8(images["rgb_volume"]))
    print(f"fly-through written to {args.out}/flythrough")
    logger.close()
    return dict(res, psnr=val_psnr, psnr_init=psnr0,
                occupied=float(occ.mean()))


if __name__ == "__main__":
    main()
