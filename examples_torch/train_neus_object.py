"""NeuS surface reconstruction of an analytic object, end to end, on the
port (the counterpart of examples/train_neus_object.py).

The "dataset" is an analytic SDF (sphere ∪ rounded box) ray-traced on
the fly. The model is `LoTDNeuSModel` (the classic LoTD by default, the
brick encoding with --brick, the F=4 brick levels with --w4), pretrained
to a sphere, trained with MSE + eikonal through the occupancy-marched,
upsampled query, then evaluated (held-out PSNR), checkpointed, meshed
(OBJ and a vertex PLY, chamfer to the ground-truth surface) and rendered
on a turntable:

    python examples_torch/train_neus_object.py --iters 800 --out /tmp/neus_run

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

C_SPH = (0.22, 0.0, 0.0)
C_BOX = (-0.22, 0.0, 0.0)

# what a run writes under --out, as the JAX script does
OUTPUTS = ["scalars.jsonl", "ckpts/ckpt_final.pt", "mesh.obj", "verts.ply"] + \
    [f"turntable/frame_{i:04d}.png" for i in range(8)]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--out", type=str, default=default_out("neus_run"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--brick", action="store_true",
                    help="use the brick encoding backend")
    ap.add_argument("--w4", action="store_true",
                    help="F=4 brick levels (implies --brick)")
    ap.add_argument("--mesh_res", type=int, default=128)
    ap.add_argument("--eikonal", type=float, default=0.03)
    return ap.parse_args(argv)


# ---------------------------------------------------------- analytic scene
def sdf_gt(p):
    """Sphere ∪ rounded box, both inside the unit cube."""
    c_sph = torch.tensor(C_SPH, device=p.device)
    c_box = torch.tensor(C_BOX, device=p.device)
    d_sph = torch.linalg.norm(p - c_sph, dim=-1) - 0.34
    q = torch.abs(p - c_box) - 0.26
    d_box = (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
             + torch.clamp(torch.amax(q, dim=-1), max=0.0) - 0.04)
    return torch.minimum(d_sph, d_box)


def normal_gt(p):
    with torch.enable_grad():
        p = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sdf_gt(p).sum(), p)
    return g


def sphere_trace(o, d, n_steps: int = 96):
    t = torch.full(o.shape[:1], 1.0, device=o.device)
    for _ in range(n_steps):
        t = t + sdf_gt(o + t[:, None] * d)
    return torch.clamp(t, 0.0, 4.0)


def trace_gt(o, d):
    """Sphere-trace the analytic SDF → normal-coloured ground truth."""
    p = o + sphere_trace(o, d)[:, None] * d
    hit = torch.abs(sdf_gt(p)) < 1e-3
    n = normal_gt(p)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    return torch.where(hit[:, None], n * 0.5 + 0.5, 0.0)


def sample_rays(n: int, gen: torch.Generator):
    o = torch.randn((n, 3), generator=gen, device=gen.device)
    o = o / torch.linalg.norm(o, dim=-1, keepdim=True) * 2.0
    tgt = torch.rand((n, 3), generator=gen, device=gen.device) * 0.5 - 0.25
    d = tgt - o
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return {"o": o, "d": d, "rgb": trace_gt(o, d)}


# ------------------------------------------------------------------- model
def model_cfg(args) -> dict:
    enc_cfg = {"lotd_cfg": {"lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
                            "lod_types": ["Dense", "Dense", "Hash", "Hash"],
                            "hashmap_size": 2 ** 16}}
    if args.w4:
        enc_cfg = {"lotd_cfg": {"lod_res": [16, 64], "lod_n_feats": 4,
                                "lod_types": ["Dense", "Hash"],
                                "hashmap_size": 2 ** 16},
                   "backend": "brick"}
    elif args.brick:
        enc_cfg["backend"] = "brick"
    return dict(
        field_cfg={"surface_cfg": {"encoding_cfg": enc_cfg,
                                   "decoder_cfg": {"D": 1, "W": 64}},
                   "radiance_cfg": {"D": 2, "W": 64},
                   "var_ctrl_cfg": {"type": "learned", "init_val": 64.0}},
        accel_cfg={"resolution": 32, "max_steps_per_ray": 96,
                   "step_size": 2 / 48},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample",
                       "upsample_inv_s_factors": [1.0, 4.0],
                       "n_importance": 12})


def setup(args, quiet: bool = False) -> Trainer:
    from nr3d_lib_tpu_torch.models.fields.sdf import pretrain_sdf_sphere
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    dev = device_of(args)
    model = LoTDNeuSModel(**model_cfg(args), seed=common.SEED_SHIFT,
                          device=dev)
    # geometric init: fit a sphere before the scene (NeuS converges far
    # faster from it)
    pre = pretrain_sdf_sphere(model.field.implicit_surface,
                              generator(dev, 0), radius=0.5, n_iters=300)
    if not quiet:
        print(f"sphere pretrain loss: {pre:.2e}")
    model.populate()
    eik_w = args.eikonal

    def loss_fn(m, b, gen):
        rendered, vb = m.ray_query(m.ray_test(b["o"], b["d"]), generator=gen)
        nab = vb.get("nablas_packed", vb.get("nablas"))
        eik = torch.mean((torch.linalg.norm(nab, dim=-1) - 1.0) ** 2)
        rgb_l = torch.mean((rendered["rgb_volume"] - b["rgb"]) ** 2)
        return rgb_l + eik_w * eik, rgb_l

    # clipped like the reference's trainers: as inv_s sharpens, eikonal
    # spikes otherwise blow the step
    return Trainer(model, loss_fn, sample_rays, lr=3e-3, rays=args.rays,
                   clip=5.0, lifecycle_seed=7000)


@torch.no_grad()
def evaluate(model) -> float:
    from nr3d_lib_tpu_torch.graphics.metrics import psnr

    b = sample_rays(2048, generator(model.device, 123))
    rendered, _ = model.ray_query(model.ray_test(b["o"], b["d"]))
    return float(psnr(rendered["rgb_volume"], b["rgb"]))


def main(argv=None) -> dict:
    from nr3d_lib_tpu_torch.graphics.pointcloud import save_ply
    from nr3d_lib_tpu_torch.graphics.trianglemesh import extract_mesh
    from nr3d_lib_tpu_torch.gui import render_turntable
    from nr3d_lib_tpu_torch.logger import Logger
    from nr3d_lib_tpu_torch.maths.knn import chamfer_distance

    args = parse(argv)
    tr = setup(args)
    model = tr.model
    logger = Logger(args.out, use_tensorboard=False)
    ckpt = tr.checkpoint_io(os.path.join(args.out, "ckpts"))
    psnr0 = evaluate(model)
    print(f"val PSNR before training: {psnr0:.2f} dB")
    res = tr.train(args.iters, logger)

    # ------------------------------------------------------ evaluation
    # the model trained in place: its occupancy grid is the trained one
    val_psnr = evaluate(model)
    print(f"val PSNR: {val_psnr:.2f} dB")
    logger.add("val", "psnr", val_psnr, args.iters)
    ckpt.save("ckpt_final.pt", it=args.iters, psnr=val_psnr)

    # mesh extraction over the learned SDF, and chamfer to the surface
    verts, faces = extract_mesh(
        lambda x: model.forward_sdf(x)["sdf"], resolution=args.mesh_res,
        filepath=os.path.join(args.out, "mesh.obj"), device=model.device)
    print(f"mesh: {len(verts)} verts / {len(faces)} faces → mesh.obj")
    cham = None
    if len(verts):
        # ground-truth surface samples from traced hits
        b = sample_rays(4096, generator(model.device, 77))
        pg = b["o"] + sphere_trace(b["o"], b["d"])[:, None] * b["d"]
        pg = pg[torch.abs(sdf_gt(pg)) < 1e-3]
        vsub = verts[np.random.default_rng(0).permutation(len(verts))[:4096]]
        c_xy, c_yx = chamfer_distance(
            torch.from_numpy(vsub).to(model.device), pg, squared=False)
        cham = float(c_xy + c_yx) / 2
        print(f"chamfer(mesh verts, GT surface): {cham:.3e}")
        logger.add("val", "chamfer", cham, args.iters)
        save_ply(os.path.join(args.out, "verts.ply"), vsub,
                 colors=np.clip(vsub * 0.5 + 0.5, 0, 1))

    frames = render_turntable(model, n_frames=8, radius=2.5, hw=(128, 128),
                              out_dir=os.path.join(args.out, "turntable"))
    print(f"wrote checkpoint, mesh + {len(frames)} turntable frames to "
          f"{args.out}")
    logger.close()
    return dict(res, psnr=val_psnr, psnr_init=psnr0, chamfer=cham,
                n_verts=len(verts), n_faces=len(faces))


if __name__ == "__main__":
    main()
