#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nr3d_lib_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

1. Prints the card (name, power limit), torch and CUDA versions.
2. Builds every CUDA kernel of the port from `nr3d_lib_tpu_torch/csrc/`
   (brick4.cu, brick.cu, gather1d.cu, permuto_cell4.cu, permuto_cell.cu,
   gaussian_blend.cu; permuto_cell4.cu and permuto_cell.cu share
   permuto_simplex.cuh, permuto_cell.cu and brick.cu warp_atomics.cuh)
   with nvcc for sm_90a, one nvcc
   per source, all started together, and prints the build time and the
   ptxas register / shared-memory lines.
3. One phase per kernel at the shapes of the paths below. Each compares
   the kernel with its plain PyTorch version on the card (tolerance
   printed), times kernel, plain version and, where one exists, a
   one-call PyTorch equivalent with CUDA events after warm-up, and prints
   the bound. F=4 (slices 1 and 2): B1 (brick4_fwd) at 589,824 points, B3
   (brick4_dydx) at 147,456, B5 (gather1d) at 393,216 lookups into a
   [4096, 64] table; B1 want_g, B2 (brick4_bwd, with and without dL/dx)
   and B4 (brick4_bwd2) at the train step's 147,456 points, also timed on
   the same points in a random order, where B1 want_g's y and words, B2's
   dL/dx and B4's dL/dg_up and dL/dx must be the same bits, B2's and B4's
   rows counting the float4 atomics before and after the warps'
   aggregation. F=2 (slice 3):
   B6 (brick_fwd) at the NeRF render's 196,608 points × 6 levels and at
   the NeuS render's 589,824 × 4, and on the inputs of each of its six
   launches in one F=2 NeuS render; B6 want_g, B7 (brick_bwd, with and
   without dL/dx), B8 (brick_dydx) and B9 (brick_bwd2) at 147,456 × 4.
   B7 and B9 are also timed on the same points in a random order, where
   their dL/dx (and B9's dL/dg_up) must be the same bits, and their rows
   count the float2 atomics before and after the warps' aggregation; B7
   is also timed on the points it receives in one more F=2 train step
   after path B's timed steps (`[brick_bwd (B7)] on the train step's
   own`), and so are B2 and B4 after the F=4 NeuS's timed steps.
   F=4 cell permuto (path C), at the dynamic NeuS's final query of
   393,216 (x,t) points × 4 levels: B14 (permuto4_fwd, also timed on the
   same points in a random order, whose rows must be the ray order's
   rows bit for bit), B15 (permuto4_bwd, with and without dL/dx; its
   dL/dx must be the same bits in the random order; its row counts the
   float4 atomics before and after the warps' aggregation) and B16
   (permuto4_dydx). F=2 cell permuto
   (path D and the field phase), each at two shapes — path D's final
   query, 393,216 (x,t) points × 5 hashed levels, and the 3D bench
   lattice, 393,216 points × 8 levels (one dense): B10 (permuto_fwd, also
   timed on the same points in a random order, whose rows must be the
   ray order's rows bit for bit), B11 and B12 (permuto_bwd without and
   with dL/dx, as B15: B12's dL/dx the same bits in the random order, the
   atomics counted) and B13 (permuto_dydx, also timed in the random
   order, where its nablas must be the same bits). Gaussian splatting
   (path E),
   at the bench scene's 1024 tiles of 16² × 256 slots: B17 (gs_blend;
   its row counts the (warp, slot) pairs of its 8 x 4 warps that its cull
   keeps, by the cull's plain mirror, beside those some pixel takes, and
   gives the issue ceiling at the kept pairs) and B18 (gs_blend_bwd,
   upstream gradients from numpy; its row also counts the (pixel, slot)
   pairs above the α floor and the (warp, slot) pairs in which any pixel
   is, the work its warp vote leaves). The forest forms of B6 and B8
   (`brick_fwd_b`, `brick_dydx_b`: a block row offset per point) on the
   inputs of each of their launches in one forest render; the forest
   forms of B7 and B9 (`brick_bwd_b`, `brick_bwd2_b`) on the inputs one
   forest train step hands them (163,840 compacted slots × 3 levels over
   64 blocks), with and without dL/dx, also timed on the same points in
   a random order, where their dL/dx and B9's dL/dg_up must be the same
   bits; their rows count the float2 atomics before and after the warps'
   aggregation, keyed on the global slot.
4. The paths, each through the entry points a user calls, with seeded
   weights, a seeded 15% occupancy and seeded rays. Launch counters are
   zeroed just before each path and read just after; every count must be
   exact. Each render is also rendered by the port on the CPU (plain
   versions), and the share of rays whose rgb and depth agree within 1e-4
   must be ≥ 99%.
   - F=4 NeuS serving (`LoTDNeuSModel`, experiments/bench_render.py
     `main_train` kind neus_compressed_w4): 10 renders of 4096 rays (6 B1,
     1 B3, 1 fused march `occ_march_budget` per render); the nablas by
     autograd (B1 want_g, B2 with dL/dx) against the split nablas (B3); one train step against the CPU
     port; 2 warm-up and 20 timed train steps that cross an occupancy
     update (6 B1 + 1 per update, 1 each of B2, B3, B4 and the fused
     march per step).
     One more render records the points of each B1 launch (`[B1
     launches]`: their sum against B1's row weighs its time).
   - Path A, F=2 NeRF serving (`LoTDNeRFModel`, bench_render.py `main`
     with use_brick=True, mode march_occ_compressed; 23,005 table rows):
     10 renders of 8192 rays (1 B6 and 1 fused march per render), then one
     render in the model's default mode march_occ (1 B6 on 786,432 points,
     1 B5).
   - Path B, F=2 NeuS (`LoTDNeuSModel`, bench_render.py `main_train` kind
     neus_compressed with use_brick=True; 9,648 table rows): 10 renders of
     4096 rays (6 B6, 1 B8, 1 fused march per render; `[B6 launches]` as B1's,
     its time over the bound the sum of the six launches' own times less
     their bounds);
     the autograd nablas (B6
     want_g, B7 with dL/dx); one train step against the CPU port; 2
     warm-up and 20 timed steps (6 B6 + 1 per update, 1 each of B7, B8,
     B9 and the fused march per step).
   - `nerf_w4_serve_8192`, the F=4 NeRF (bench_render.py `main(w4=True)`:
     lod_res [16, 64, 512], F=4, Dense/Hash/Hash): 10 renders of 8192
     rays in march_occ_compressed, then 10 in march_occ (1 B1 a render in
     each, and 1 fused march or 1 B5).
   - `nerf_f2_fixed_train_4096`, the NeRF train step (bench_render.py
     `main_train` kind nerf, use_brick=True: path A's field,
     `nerf_ray_query_fixed` at 64 samples a ray, MSE(rgb, |d|),
     Adam(5e-3), no lifecycle): one step against the CPU port, 2 warm-up
     and 20 timed steps (1 B6 and 1 B7 without dL/dx per step).
   - `neus_f2_coarse_train_4096`, the NeuS train step (kind neus,
     use_brick=True: path B's field, `coarse_multi_upsample` with 64
     coarse samples and three rounds of 32, MSE + 0.1·eikonal over every
     queried nablas): one step against the CPU port, 2 warm-up and 20
     timed steps (5 B6, 1 each of B7, B8, B9 per step).
   - `forest_serve_8192`, the forest NeuS (`LoTDForestNeuSModel`,
     bench_render.py `main_forest`: 64 blocks of 0.5 at resolution
     (4,4,4), per-block F=2 brick tables lod_res [8, 16, 32], segmented
     marching of 8 segments × 16 steps, two upsample rounds, budgeted
     compaction): 10 renders of 8192 rays (5 `brick_fwd_b` and 1
     `brick_dydx_b` per render); the CPU comparison keeps as many rays
     as fit CPU_STEP_BUDGET_S and prints how many.
   - `forest_train_4096`, the forest NeuS trained as
     examples/train_forest_street.py:119-147 does (the same model,
     another seed): perturbed `ray_query`, MSE(rgb, |d|) + 0.01·mean((‖
     nablas_packed‖ − 1)²) over every packed slot, Adam(1e-2), the
     lifecycle every `lifecycle_update_every` steps; 4096 rays from the
     radius-2.5 sphere. One step against the CPU port (its rays cut to
     CPU_STEP_BUDGET_S), 2 warm-up and 20 timed steps (5 `brick_fwd_b`,
     1 each of `brick_dydx_b`, `brick_bwd_b`, `brick_bwd2_b` per step,
     +1 `brick_fwd_b` at each occupancy update).
   - Path C, the dynamic (x,t) NeuS (`DynamicPermutoNeuSModel`,
     examples/configs/dynamic_permuto_w4.yaml at full width; 14,080 table
     rows), rays with seeded timestamps in [-1, 1]: 10 renders of 4096
     rays (4 B14 and 1 B16 per render: 64 coarse samples, two upsample
     rounds of 16, the final query of 96 per ray); one train step against
     the CPU port; 2 warm-up and 20 timed steps (4 B14 + 1 per occupancy
     update of 8 time keys × 8192 cells, 1 each of B15 without dL/dx and
     B16 per step; the nablas' backward is plain PyTorch, as the JAX
     package computes it in XLA).
   - Field phase, the static 3D permuto fields (`PermutoSDF`,
     `PermutoNeRF`, F=2 cell backend at bench.py's lattice: 30,657 rows)
     on 393,216 points along the rays: `forward_sdf_nablas` (1 B10 + 1
     B13); the autograd nablas through `forward_sdf` (1 B10 + 1 B12),
     held against the split nablas; one `PermutoNeRF` density forward and
     backward (1 B10 + 1 B11). Each is held against the CPU port.
   - Path D, the dynamic (x,t) NeuS on the F=2 cell permuto
     (`DynamicPermutoNeuSModel` with `permuto_cfg: {backend: cell}`, so
     the field's defaults: res_list [8, 16, 32, 64, 128], 4096 rows, five
     hashed levels, 20,480 rows), as path C otherwise: 10 renders (4 B10
     and 1 B13 per render); one train step against the CPU port; 2
     warm-up and 20 timed steps (4 B10 + 1 per occupancy update, 1 B11
     and 1 B13 per step).
   - Path E, 3D Gaussian splatting (`rasterize_gaussians_tiled` with
     blend_backend "pallas", bench.py:397-427 and
     experiments/bench_render.py `main_train_gaussian`): 500,000 seeded
     gaussians at 512², tile 16, 16 tiles per gaussian, capacity 256. 10
     renders (1 B17 each), held against the CPU port pixel by pixel (≥ 99%
     of pixels within 1e-4 on rgb, alpha and depth); one train step (MSE
     to a seeded target, quats normalized in the loss) against the CPU
     port; 2 warm-up and 20 timed steps of Adam(1e-3) (1 B17 + 1 B18 each).
   - `neus_obj_w4_train_2048`, examples/train_neus_object.py --w4 at its
     own width (F=4 brick lod_res [16, 64], decoder W 64, radiance D 2 W
     64, learned inv_s from 64, accel 32³ with 96 steps of 2/48, query
     `march_occ_multi_upsample` with factors [1, 4] and 12 importance
     samples): `pretrain_sdf_sphere(radius 0.5, 300 iterations)`, then
     one step (MSE(rgb, |d|) + 0.03·the mean eikonal over every slab
     sample, the global norm clipped to 5 as optax does, Adam(3e-3), the
     lifecycle every `lifecycle_update_every` steps) against the CPU
     port, 2 warm-up and 20 timed steps on 2048 rays (4 B1, 1 each of B2,
     B3, B4, B5 per step, +1 B1 at each occupancy update).
   - `neus_obj_w4_serve_2048` and `neus_obj_f2_serve_2048`: the example's
     unperturbed validation render of the pretrained F=4 model and of its
     --brick variant (F=2, lod_res [16, 32, 64, 128], D/D/H/H): 10 renders
     of 2048 rays (1 B5, 4 B1 or B6 — the full slab, two rounds, the
     final query —, 1 B3 or B8 per render).
   - `neus_sphere_trace_serve_2048`: the pretrained F=4 model in
     `sphere_trace` (16 band and 8 tail samples, hit threshold 5e-4, at
     most 64 iterations, seeded from the accel's grid): 10 renders (1 B5,
     iterations + 2 B1, 1 B3 per render); prints the iterations and the
     hit share.
   - `nerf_f2_mup_serve_8192`: path A's model in
     `march_occ_multi_upsample_compressed` (0.25, 32 fine samples, no
     coarse ones): 10 renders of 8192 rays (2 B6, 1 fused march per
     render).
   - `dyn_permuto_xla_serve_4096` and `dyn_permuto_xla_train_4096`:
     `DynamicPermutoNeuSModel` at its default field, the classic 4D
     lattice (res [8 … 128], 2 features, 2^17 entries a level: plain
     PyTorch, as JAX computes it in XLA; no kernel launches), otherwise
     path D's settings: 10 renders, one step against the CPU port, 2
     warm-up and 20 timed steps.
   - Field phase, classic lattice: `PermutoSDF` and `PermutoNeRF` at the
     JAX defaults (res [8 … 128], 2^17) on the same 393,216 points: the
     autograd nablas, an eikonal step through their second order (peak
     memory printed), a density step; held against the CPU port on the
     first 65,536 points; no kernel launches.
   - The three example trainers at their default flags, on the classic
     LoTD (no `backend` key; `ops/lotd.py`, plain PyTorch, as JAX
     computes it in XLA). `neus_obj_xla_serve_2048` and
     `neus_obj_xla_train_2048`: examples/train_neus_object.py (classic
     F=2 [16, 32, 64, 128], D/D/H/H, 2^16; otherwise as
     `neus_obj_w4_train_2048`): the sphere pretrain, 10 renders (1 B5,
     no brick kernel), one step against the CPU port, 2 warm-up and 20
     timed steps (1 B5 a step). `nerf_xla_fixed_serve_2048` and
     `nerf_xla_fixed_train_2048`: examples/train_nerf_synthetic.py
     ([16, 32, 64], D/D/H, 2^14; `nerf_ray_query_fixed` at 64 samples,
     Adam(5e-3); no launches). `forest_xla_serve_2048` and
     `forest_xla_train_1024`: examples/train_forest_street.py (6×1×1
     blocks of 1.0, [8, 16, 32] all Dense, decoder W 64, radiance D 1 W
     64; `segments` marching, 8 × 24, 128 steps, 8 importance samples;
     the example's street cameras; Adam(1e-2); no launches). Each
     render's CPU comparison keeps the rays the CPU port renders within
     CPU_RENDER_BUDGET_S.
   - The last three example trainers at their default flags (A12), 2048
     rays each, the examples' ray distributions from numpy, tables seeded
     in ±0.1. `emernerf_serve_2048` and `emernerf_train_2048`:
     examples/train_dynamic_scene.py's `EmerNeRFModel` (static classic
     LoTD [16, 32, 64] D/D/H at 2^15, dynamic classic 4D lattice [8, 16,
     32] at 2^15, temporal aggregation, a 16³ static grid and 8 time-keyed
     dynamic grids, 64 march steps; `populate`, then both grids' values
     drawn around the threshold, so each is part empty and B5's lookups
     matter): 10 renders (2 B5 each:
     the static grid, the any-time union of the dynamic grids), one step
     of the example's loss (MSE to |d| + 1e-3·dynamic sparsity + 1e-4
     each of flow smoothness, flow cycle and shadow; Adam(4e-3), the
     lifecycle every step) against the CPU port, 2 warm-up and 20 timed
     steps (2 B5 a step, none at the occupancy updates). `gen_shapes_*`
     (examples/train_generative_shapes.py: `GenerativePermutoNeuSModel
     Batched`, 4 instances, latent_dim 4, the classic 7D lattice [8 … 64]
     at 2^15, 32 coarse + 2 × 8 samples) and `cond_dyn_*`
     (train_conditional_dynamic.py: `DynamicGenerativeNeuSModel`, the
     classic 8D lattice [8, 16, 32]): 10 renders, one step (MSE to |d| +
     0.03·eikonal + 1e-4·the latents' mean square, the global norm
     clipped to 5, Adam(3e-3)) against the CPU port, 22 steps; no kernel
     launches. `gen_cell_serve_2048`: the generative model with
     `backend: cell` at latent_dim 2 (d = 5): 10 renders (4 B10 + 1 B13
     each). B5 is also held against its plain take at the EmerNeRF
     render's 131,072 lookups a grid, and B10 and B13 against their plain
     versions at the cell model's final query of 98,304 5D points (added
     to their rows: `*_emernerf_*`, `*_gen5`). The steps' CPU comparisons
     keep the rays that fit CPU_STEP_BUDGET_A12_S.
   Each path prints ms per call (median, quartiles), Krays/s (path E: fps
   and Mpix/s), peak memory and a device-time profile by kernel.
   - The ray, pack and maths layers (A14, `_a14_paths`), on the --w4
     object model pretrained to the radius-0.5 sphere. `dmtet_w4_extract
     _128` and `dmtet_w4_step_128`: `DMTet` at resolution 128 over the
     box (2,097,152 vertices, 12,290,298 tets), the SDF the field's
     `forward_sdf` at the base vertices (1 B1), a learned deformation
     from zero; the extraction timed, `to_mesh`'s median radius within
     0.02 of 0.5; one step of the JAX package's test loss (radius 0.4)
     plus a deformation L2, Adam on the table and the deformation (1 B2
     without dL/dx), its peak memory; the CPU route given the card's SDF
     values: masks bitwise, triangles within 1e-5, the SDF's and the
     deformation's gradients within 1e-4 relative L2.
     `neus_obj_w4_pose_train_2048`: an `OpenCVCameraIntrinsics` camera
     (400², seeded k1, k2, p1, p2) at radius 2, its pose a
     `TransformExpSE3` ∘ `TransformRT` started 2° and 0.02 off; 2048
     pixels lifted to rays, the target the render at the true pose; the
     field frozen, Adam on (w, v, θ), step 1 against the CPU route (loss
     1e-4 relative, gradients 1e-2 relative L2), 2 warm-up and 20 timed
     steps (3 B1, 1 B1 want_g, 1 B2 and 1 B4 with dL/dx, 1 B3, 1 B5 a
     step), the loss falling. `pack_maths`: every new `pack_ops` and
     `raysample` function at the F=4 bench render's 4096 packs × 96
     slots (ragged, empty packs, padding), card against CPU (integers,
     masks and orders bitwise, floats within 1e-5 of the largest
     entry); transform round trips on 1,048,576 rotations; the depth
     completion of a 1280 × 1920 map at 5% bitwise; `dist_to_nn3_mean`
     at path E's 500,000 means against a float64 brute force on 4,096
     rows.
   - Infra and multi-GPU (A15, `_a15_paths`). `ddp_w4_train_4096`: the
     production F=4 step through `parallel.train.make_sharded_train_step`
     on two gloo ranks that share the card (spawned after the build;
     2048 rays each, each its own draws, the occupancy updates' draws
     the same), a warm-up and 3 timed steps, held against one process on
     the same halves whose Adam steps on the ranks' gradients (each
     step's gradients within 1e-5 relative L2, the losses within 1e-6,
     the parameters within 1e-4 after 5 steps, all before the first
     occupancy update), the ranks' parameters and grids
     the same bits through the update at it = 16; B1–B5 counted on rank
     0; then the step on a mesh over an NCCL group of world size 1, where
     it runs no collective, against a plain step (gradients within
     1e-5).
     `config_zoo`: each `examples/configs/*.yaml` through `load_config`
     and `instantiate` on the card, a render of 4096 rays (512 of them
     within 1e-4 of the CPU route on ≥ 99%), one Adam step; B1, B2, B5,
     B6, B7, the forest forms and B14–B16 among their launches.
     `chunked_w4`: `loop_chunks` over B1 at DMTet's 2,097,152 vertices
     bitwise one call's (4 launches), `scan_chunks` over B2 within 1e-6
     relative L2 (4 launches). `viewer_w4`: `InteractiveViewer` over the
     --w4 model at 256², every layer's PNG read back bitwise its render,
     the occupancy and AABB layers drawn, `color_depth` against the CPU
     route. `profile_ckpt`: `Profiler(warmup=2, record_frames=5,
     sync=True)` around the production step's stages; `save_sharded`/
     `load_sharded` of the model's and Adam's state, the next step from
     both the same bits.
   - The six example trainers as programs (`examples_torch/`,
     `TRAINER_RUNS`): each through its `main([...])` at its default
     model, rays and evaluation sizes with `--iters` cut (300 for the
     NeuS object and the NeRF, 200 for the rest), then the NeuS object
     under `--w4` and the forest under `--brick` for 20. Each run must
     write every file the JAX script writes, raise its held-out PSNR
     above the untrained model's, end with a mean loss over its last 5
     steps below its first 5's, and launch its kernels (B5 wherever the
     path queries occupancy; B1–B4 under `--w4`; the forest forms of
     B6–B9 under `--brick`); a run resumed from a checkpoint at step k
     (model, Adam, the run's generator) takes steps k and k+1 with the
     uninterrupted run's losses within 1e-5 relative. One `[trainer …]`
     line each: iterations, seconds, ms/iter, PSNR (and chamfer), peak
     memory, the card.
5. A `{"kernels": [...]}` JSON line, then the card's name and power limit,
   then the last line `{"ok": true, "device": {...}}`.

TF32 is off for matmuls and cuDNN (`allow_tf32 = False`): the reference
comparisons hold float32 end to end. Every failure raises and the script
exits non-zero; it exits non-zero without printing a result when no CUDA
device is present or when the port's package is not beside it.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
N_RAYS = 4096             # the NeuS paths' batch
N_RAYS_NERF = 8192        # the NeRF path's batch
N_RENDERS = 10
N_WARMUP_STEPS = 2
N_STEPS = 20              # timed; it = 3..22 crosses the update at it = 16
CPU_STEP_BUDGET_S = 60.0  # the GPU-vs-CPU step check cuts its rays to fit
GS_N = 500_000            # path E: bench.py S5's gaussians
GS_HW = (512, 512)
GS_CFG = dict(tile=16, tiles_per_gaussian=16, tile_capacity=256)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores


def _neus_cfg(lotd_cfg: dict) -> dict:
    """experiments/bench_render.py:143-175, the compressed NeuS."""
    return dict(
        field_cfg={"surface_cfg": {
            "encoding_cfg": {"lotd_cfg": lotd_cfg, "backend": "brick"},
            "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 2, "W": 64}},
        accel_cfg={"resolution": 64, "max_steps_per_ray": 96,
                   "step_size": 2.0 / 96},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample_compressed",
                       "compression_factor": 0.25,
                       "march_budget_factor": 0.5})


# the production F=4 configuration (kind neus_compressed_w4)
PROD_CFG = _neus_cfg({"lod_res": [16, 64], "lod_n_feats": 4,
                      "lod_types": ["Dense", "Hash"], "hashmap_size": 2 ** 16})
# path B: kind neus_compressed, use_brick=True (F=2)
NEUS_F2_CFG = _neus_cfg({"lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
                         "lod_types": ["Dense", "Dense", "Hash", "Hash"],
                         "hashmap_size": 2 ** 16})
# path C: examples/configs/dynamic_permuto_w4.yaml (+ _base_.yaml: 4096 rays)
DYN_CFG = dict(
    field_cfg={"surface_cfg": {
        "permuto_cfg": {"res_list": [4.0, 11.0, 32.0, 90.0],
                        "backend": "cell", "n_feats": 4,
                        "hashmap_rows": 4096},
        "decoder_cfg": {"D": 1, "W": 64}},
        "radiance_cfg": {"D": 2, "W": 64}},
    n_time_keys=8)
# path D: the same model with `permuto_cfg: {backend: cell}`, so the
# field's own defaults (models/fields_dynamic.py:38-46): F=2, res_list
# [8, 16, 32, 64, 128], 4096 rows
PATHD_CFG = dict(
    field_cfg={"surface_cfg": {"permuto_cfg": {"backend": "cell"},
                               "decoder_cfg": {"D": 1, "W": 64}},
               "radiance_cfg": {"D": 2, "W": 64}},
    n_time_keys=8)
# the field phase: bench.py:452-453's 3D cell lattice, F=2
FIELD_PERMUTO = {"res_list": [16.0 * 2 ** (0.5 * i) for i in range(8)],
                 "backend": "cell", "hashmap_rows": 4096}
# path A: experiments/bench_render.py:21-55, use_brick=True,
# mode march_occ_compressed (F=2)
NERF_CFG = dict(
    field_cfg={"encoding_cfg": {"lotd_cfg": {
        "lod_res": [16, 32, 64, 128, 256, 512], "lod_n_feats": 2,
        "lod_types": ["Dense", "Dense", "Dense", "Hash", "Hash", "Hash"],
        "hashmap_size": 2 ** 17}, "backend": "brick"},
        "density_decoder_cfg": {"D": 1, "W": 64},
        "radiance_cfg": {"D": 2, "W": 64}},
    accel_cfg={"resolution": 64, "max_steps_per_ray": 96,
               "step_size": 2.0 / 96},
    ray_query_cfg={"query_mode": "march_occ_compressed",
                   "compression_factor": 0.25})


# the F=4 NeRF: experiments/bench_render.py:37-43 (`main(w4=True)`, brick;
# mode march_occ_compressed, then march_occ)
NERF_W4_CFG = dict(NERF_CFG, field_cfg=dict(
    NERF_CFG["field_cfg"], encoding_cfg={"lotd_cfg": {
        "lod_res": [16, 64, 512], "lod_n_feats": 4,
        "lod_types": ["Dense", "Hash", "Hash"], "hashmap_size": 2 ** 17},
        "backend": "brick"}))
# the NeRF train step: bench_render.py:122-133 (`main_train(kind="nerf",
# use_brick=True)`): path A's field, no accel in the step,
# nerf_ray_query_fixed at 64 samples a ray
NERF_FIXED_CFG = dict(field_cfg=NERF_CFG["field_cfg"])
N_SAMPLES_FIXED = 64
# the NeuS train step: bench_render.py:139-160 (`main_train(kind="neus",
# use_brick=True)`): 64 coarse samples, three upsample rounds of 32
NEUS_COARSE_CFG = dict(
    field_cfg=NEUS_F2_CFG["field_cfg"],
    ray_query_cfg={"query_mode": "coarse_multi_upsample", "n_coarse": 64})
# the forest: bench_render.py:257-292 (`main_forest`): 64 blocks of 0.5,
# per-block F=2 brick tables, segmented marching
# examples/train_neus_object.py: the NeuS object model (--w4, and its
# --brick variant), 2048 rays a step, query march_occ_multi_upsample
N_RAYS_OBJ = 2048
OBJ_LR, OBJ_CLIP, OBJ_EIKONAL = 3e-3, 5.0, 0.03


def _obj_cfg(lotd_cfg: dict, query: dict = None,
             backend: str = "brick") -> dict:
    """examples/train_neus_object.py:90-110 (`backend=None`: no backend
    key, the example's default, the classic LoTD)."""
    enc = {"lotd_cfg": lotd_cfg}
    if backend is not None:
        enc["backend"] = backend
    return dict(
        field_cfg={"surface_cfg": {
            "encoding_cfg": enc,
            "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 2, "W": 64},
            "var_ctrl_cfg": {"type": "learned", "init_val": 64.0}},
        accel_cfg={"resolution": 32, "max_steps_per_ray": 96,
                   "step_size": 2 / 48},
        ray_query_cfg=query or {"query_mode": "march_occ_multi_upsample",
                                "upsample_inv_s_factors": [1.0, 4.0],
                                "n_importance": 12})


OBJ_W4_CFG = _obj_cfg({"lod_res": [16, 64], "lod_n_feats": 4,
                       "lod_types": ["Dense", "Hash"],
                       "hashmap_size": 2 ** 16})
OBJ_F2_CFG = _obj_cfg({"lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
                       "lod_types": ["Dense", "Dense", "Hash", "Hash"],
                       "hashmap_size": 2 ** 16})
# the three example trainers at their default flags: the classic LoTD
# (no `backend` key), plain PyTorch. examples/train_neus_object.py:90-92
OBJ_XLA_CFG = _obj_cfg(OBJ_F2_CFG["field_cfg"]["surface_cfg"]
                       ["encoding_cfg"]["lotd_cfg"], backend=None)
# examples/train_nerf_synthetic.py:58-74: rendered and trained by
# nerf_ray_query_fixed at 64 samples a ray, Adam(5e-3), no lifecycle
NERF_XLA_CFG = dict(field_cfg={
    "encoding_cfg": {"lotd_cfg": {"lod_res": [16, 32, 64], "lod_n_feats": 2,
                                  "lod_types": ["Dense", "Dense", "Hash"],
                                  "hashmap_size": 2 ** 14}},
    "density_decoder_cfg": {"D": 1, "W": 64},
    "radiance_cfg": {"D": 2, "W": 64}})
NERF_XLA_LR = 5e-3
# examples/train_forest_street.py:52-62: a 6-block street, all-Dense
# levels, segments marching; 1024 rays a step, Adam(1e-2)
FOREST_XLA_CFG = dict(
    space_cfg={"resolution": (6, 1, 1), "origin": (-3.0, -0.5, -0.5),
               "block_size": 1.0},
    field_cfg={"surface_cfg": {
        "lotd_cfg": {"lod_res": [8, 16, 32], "lod_n_feats": 2,
                     "lod_types": ["Dense", "Dense", "Dense"]},
        "decoder_cfg": {"D": 1, "W": 64}},
        "radiance_cfg": {"D": 1, "W": 64}},
    n_march_steps=128, march_mode="segments", max_segments=8,
    steps_per_segment=24, n_importance=8)
N_RAYS_FOREST_TRAIN = 1024
CPU_RENDER_BUDGET_S = 20.0  # the classic renders' CPU comparisons
# the same F=4 model in sphere_trace at the JAX defaults
TRACE_CFG = dict(OBJ_W4_CFG, ray_query_cfg={"query_mode": "sphere_trace"})
# the --w4 model with the use_ema=False getter grid (occgrid_accel.py:32-35):
# every update re-queries the 32^3 cell centres (one B1 launch)
OBJ_W4_GETTER_CFG = dict(OBJ_W4_CFG, accel_cfg=dict(OBJ_W4_CFG["accel_cfg"],
                                                    use_ema=False))


def _bf16_cfg(cfg: dict) -> dict:
    """The object model with bfloat16 compute in the classic encoding and
    the SDF decoder (float32 master parameters)."""
    surf = cfg["field_cfg"]["surface_cfg"]
    surf = dict(surf, encoding_cfg=dict(surf["encoding_cfg"],
                                        compute_dtype="bfloat16"),
                decoder_cfg=dict(surf["decoder_cfg"],
                                 compute_dtype="bfloat16"))
    return dict(cfg, field_cfg=dict(cfg["field_cfg"], surface_cfg=surf))


OBJ_XLA_BF16_CFG = _bf16_cfg(OBJ_XLA_CFG)
# bf16 keeps 8 significant bits (a step of 2^-8 relative). The card's bf16
# matmuls and scatter-adds round in another order from the CPU's: rgb and
# depth within 8 steps (2^-5) on >= 99% of rays; the loss, a mean of many
# rays, within one step (2^-8) relative; each gradient within 2^-4
# relative L2 (a table entry's gradient is a bf16 sum of n ~ 400 terms,
# whose rounding is ~ sqrt(n) * 2^-9 ~ 2^-4.7 whichever the order)
BF16_TOL, BF16_LOSS_TOL, BF16_GRAD_TOL = 2.0 ** -5, 2.0 ** -8, 2.0 ** -4
# the MLP-only fields at JAX's defaults on 4,096 rays x 64 points, held
# against the CPU on the first N_MLP_CPU
N_MLP_PER_RAY = 64
N_MLP_CPU = 16_384
# DynamicPermutoNeuSModel at its default field (the classic 4D lattice,
# models/fields_dynamic.py defaults), otherwise path D's settings
DYN_XLA_CFG = dict(
    field_cfg={"surface_cfg": {"decoder_cfg": {"D": 1, "W": 64}},
               "radiance_cfg": {"D": 2, "W": 64}},
    n_time_keys=8)
N_FIELD_CPU = 65_536      # the classic field phase's CPU comparison
N_RAYS_FOREST = 8192
FOREST_CFG = dict(
    space_cfg={"resolution": (4, 4, 4), "origin": (-1.0, -1.0, -1.0),
               "block_size": 0.5},
    field_cfg={"surface_cfg": {
        "lotd_cfg": {"lod_res": [8, 16, 32], "lod_n_feats": 2,
                     "lod_types": ["Dense", "Dense", "Hash"],
                     "hashmap_size": 2 ** 12, "backend": "brick"},
        "decoder_cfg": {"D": 1, "W": 64}},
        "radiance_cfg": {"D": 2, "W": 64}},
    n_march_steps=128, march_mode="segments", max_segments=8,
    steps_per_segment=16)

# A12, the last three example trainers at their default flags (2048 rays
# a step each). examples/train_dynamic_scene.py:98-110: EmerNeRF, the
# static classic LoTD and the dynamic classic 4D lattice, Adam(4e-3)
EMER_CFG = dict(
    field_cfg={"static_cfg": {"lotd_cfg": {
        "lod_res": [16, 32, 64], "lod_n_feats": 2,
        "lod_types": ["Dense", "Dense", "Hash"], "hashmap_size": 2 ** 15}},
        "dynamic_permuto_cfg": {"res_list": [8.0, 16.0, 32.0], "n_feats": 2,
                                "log2_hashmap_size": 15}},
    accel_cfg={"resolution": (16, 16, 16)}, n_time_keys=8, n_march_steps=64)
EMER_LR = 4e-3
N_INSTANCES = 4
GEN_LR, GEN_CLIP, GEN_EIKONAL, GEN_PRIOR = 3e-3, 5.0, 0.03, 1e-4
CPU_STEP_BUDGET_A12_S = 20.0  # the A12 steps' CPU comparisons


def _gen_cfg(permuto_cfg: dict, latent_dim: int = 4) -> dict:
    """examples/train_generative_shapes.py:93-103 and
    train_conditional_dynamic.py:91-102: 4 instances, latents N(0, 0.1²),
    decoder W 64, radiance D 2 W 64, inv_s from 64, 32 coarse samples and
    two upsample rounds of 8."""
    return dict(n_instances=N_INSTANCES, latent_dim=latent_dim,
                latent_std=0.1,
                field_cfg={"surface_cfg": {"permuto_cfg": permuto_cfg,
                                           "decoder_cfg": {"D": 1, "W": 64}},
                           "radiance_cfg": {"D": 2, "W": 64},
                           "var_ctrl_cfg": {"type": "learned",
                                            "init_val": 64.0}},
                ray_query_cfg={"n_coarse": 32,
                               "upsample_inv_s_factors": [1.0, 4.0],
                               "n_importance": 8})


# the classic 7D lattice (3 + latent_dim 4), [8, 16, 32, 64] at 2^15
GEN_CFG = _gen_cfg({"res_list": [8.0, 16.0, 32.0, 64.0], "n_feats": 2,
                    "log2_hashmap_size": 15})
# the classic 8D lattice (3 + 4 + t), [8, 16, 32] at 2^15
COND_DYN_CFG = _gen_cfg({"res_list": [8.0, 16.0, 32.0], "n_feats": 2,
                         "log2_hashmap_size": 15})
# GEN_CFG on the F=2 cell layout at latent_dim 2 (d = 5, the most the
# cell row packs): B10 and B13
GEN_CELL_CFG = _gen_cfg({"res_list": [8.0, 16.0, 32.0, 64.0], "n_feats": 2,
                         "backend": "cell"}, latent_dim=2)


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sass_functions(lib: Path) -> dict:
    """Each kernel of a built library → its SASS as (address, instruction)
    pairs, NOPs aside (`cuobjdump -sass` from the toolkit of `nvcc`)."""
    from nr3d_lib_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if name and m and "NOP" not in m.group(2):
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _walk_per_pair(code: list):
    """Instructions a pair of the innermost loop that evaluates alpha (a
    backward branch around an `MUFU.EX2`): the loop's instructions over
    the pairs it evaluates (its `MUFU.EX2`s); None if there is no such
    loop."""
    best = None
    for addr, ins in code:
        m = re.search(r"\bBRA (?:\S+, )?0x([0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [i for a, i in code if int(m.group(1), 16) <= a <= addr]
        pairs = sum("MUFU.EX2" in i for i in body)
        if pairs and (best is None or len(body) < best[0]):
            best = (len(body), pairs)
    return best[0] / best[1] if best else None


def _sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.strip().splitlines()[0])


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of `fn`, in ms. The calls are queued behind
    a ~0.1 s device-side sleep, so the host's launch overhead overlaps the
    sleep and the CUDA events time the device work alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _b6_bound(n: int, L: int, table_numel: int, want_g: bool = False):
    """B6's bound: x in, y (and with want_g the corner values, 8 corners ×
    8 B a level) out, the table once; each (point, level) 3 axes × 4 index
    ops + 8 corners × (2 weight muls + 2 FMAs) = 60 float ops."""
    return _bound(n * (12 + 8 * L + (64 * L if want_g else 0)) +
                  table_numel * 4, n * L * 60)


def _b1_want_g_bound(n: int, L: int, table_bytes: int):
    """B1 want_g's bound: B1's bytes (x in, y out, the packed table once)
    plus 8 corners × 8 B of words a (point, level) out; each (point,
    level) 12 index ops + 8 corners × (2 weight muls + 4 products + 4
    adds) = 92 operations."""
    return _bound(n * (12 + 16 * L + 64 * L) + table_bytes, n * L * 92)


def _b13_bound(n: int, dim: int, L: int, table_bytes: int):
    """B13's bound: x, g_up in and dx out, the table once; each (point,
    level) the simplex search + (d+1) × 3 for g·val + the elevation vjp
    ~8(d+1)."""
    return _bound(n * (4 * dim + 8 * L + 4 * dim) + table_bytes,
                  n * L * (_simplex_ops(dim) + 11 * (dim + 1)))


def _b8_bound(n: int, L: int, table_bytes: int):
    """B8's bound: x, g_up in and dx out, the table once; each (point,
    level) 12 index ops + 8 corners × (3 for g·val + 9) + 3 scale FMAs =
    111 float ops."""
    return _bound(n * (12 + 8 * L + 12) + table_bytes, n * L * 111)


def _b3_bound(n: int, L: int, table_bytes: int):
    """B3's bound: x, g_up in and dx out, the packed table once; each
    (point, level) 8 corners × (7 for g·val + 3 axes × 3) + 3 axes × 4
    index ops + 3 scale FMAs = 146 float ops."""
    return _bound(n * (12 + 16 * L + 12) + table_bytes, n * L * 146)


def _b16_bound(n: int, dim: int, L: int, table_bytes: int):
    """B16's bound: x, g_up in and dx out, the packed table once; each
    (point, level) the simplex search + 5 vertices × (4 unpacks + 7 for
    g·val) + the elevation vjp (~30)."""
    return _bound(n * (4 * dim + 16 * L + 4 * dim) + table_bytes,
                  n * L * (_simplex_ops(dim) + 55 + 30))


PROFILE_LEAD_S = 0.05
PROFILE_PRIMERS = 8


def _profiled(run, calls: int):
    """A torch.profiler session (host and device activities) over `calls`
    calls of `run`. A session at times loses the device events of its first
    kernels (on an H100, the DMTet step's B1 when it came first; two
    element-wise kernels in front of it another time), so each session
    first launches PROFILE_PRIMERS device sleeps (`spin_kernel`, left out
    of every count and breakdown), waits for them, and idles PROFILE_LEAD_S
    on the host before the first call and after the last kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PRIMERS):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_LEAD_S)
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        time.sleep(PROFILE_LEAD_S)
    return prof


def _primer(key: str) -> bool:
    """Whether a profiler key is one of `_profiled`'s device sleeps."""
    return "spin_kernel" in key


def _profile(run, wall_ms: float, what: str) -> None:
    """Device time by kernel over two calls of `run` (torch.profiler), and
    the share of one call's wall time `wall_ms` that the device is busy.
    Only device-side events count (kernels, memsets, copies): an aten op's
    row repeats the device time of the kernels it launched, and a user
    annotation (such as the optimizer step's) spans kernels already
    counted."""
    from torch.autograd import DeviceType

    prof = _profiled(run, 2)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or _primer(ev.key) or \
                getattr(ev, "is_user_annotation", False):
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t / 2e3, ev.count / 2, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"[profile] device time by kernel, per {what}: total "
          f"{total:.3f} ms in {sum(r[1] for r in rows):.0f} device events "
          f"(kernels, memsets, copies); busy {total / wall_ms * 100:.1f}% "
          f"of the {wall_ms:.3f} ms wall time")
    # a kernel's key is its signature, "void name<...>(...)" for a
    # template instance
    ours = [r for r in rows if r[2].removeprefix("void ").startswith(
        ("brick", "gather1d", "occ_march", "permuto", "gs_blend"))]
    ours_ms = sum(r[0] for r in ours)
    print(f"[profile] the port's kernels (brick4_*, brick_*, gather1d, "
          f"occ_march_*, permuto4_*, permuto_*, gs_blend*): "
          f"{ours_ms:.4f} ms, {ours_ms / max(total, 1e-9) * 100:.1f}% of the "
          f"device time")
    # the top 20, then the port's kernels below them
    for ms, count, key in rows[:20] + [r for r in ours if r not in rows[:20]]:
        print(f"[profile]   {ms:8.4f} ms {ms / max(total, 1e-9) * 100:5.1f}% "
              f"x{count:<4.0f} {key[:90]}")


def _rays(n: int, seed: int, radius: float = 2.0):
    """experiments/bench_render.py's ray distribution, from numpy (the
    forest's at radius 2.5)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * radius
    d = -o / radius + rng.normal(size=(n, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _ray_points(o, d, n_per_ray: int, seed: int):
    """Points in [0,1]^3 spread along the rays inside the unit box, sorted
    per ray like a render's sample slab."""
    from nr3d_lib_tpu_torch.graphics.raytest import ray_box_intersection
    import torch

    near, far, _ = ray_box_intersection(o, d, -1.0, 1.0)
    g = torch.Generator(device=o.device).manual_seed(seed)
    u = torch.sort(torch.rand(o.shape[0], n_per_ray, generator=g,
                              device=o.device), -1).values
    t = near[:, None] + (far - near)[:, None] * u
    x = o[:, None, :] + d[:, None, :] * t[..., None]
    return (x.reshape(-1, 3) * 0.5 + 0.5).clamp(0.0, 1.0).contiguous()


def _dyn_points(o, d, ts, n_per_ray: int, seed: int):
    """(x,t) lattice inputs in [0,1]^4: `_ray_points` with each ray's
    timestamp, mapped as the dynamic field maps it (t·0.5 + 0.5)."""
    import torch

    x = _ray_points(o, d, n_per_ray, seed)
    t = torch.repeat_interleave(ts, n_per_ray)[:, None] * 0.5 + 0.5
    return torch.cat([x, t], -1).contiguous()


def _tested(model, o, d, extra=None):
    """The model's ray test, plus per-ray inputs (the dynamic model's
    `ts`) cut to the rays and moved to their device."""
    rt = model.ray_test(o, d)
    for k, v in (extra or {}).items():
        rt[k] = v[:o.shape[0]].to(o.device)
    return rt


def _seed_weights(model, enc, seed: int) -> None:
    """Seeded weights that give a non-trivial render: table values in
    ±0.1 (the init is ±1e-4), and ln_s = ln(64)/10 for a NeuS."""
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        p = enc.flattened_params
        p.copy_(torch.from_numpy(rng.uniform(
            -0.1, 0.1, tuple(p.shape)).astype(np.float32)))
        if hasattr(model.field, "var_ctrl"):
            model.field.var_ctrl.ln_s.fill_(float(np.log(64.0) / 10.0))


def _step_loss(model, o, d, extra=None, **query):
    """experiments/bench_render.py:197-221: MSE(rgb, |d|) + 0.1·eikonal
    over the valid packed nablas (the compressed query), or over every
    sample's nablas (the dynamic query, which keeps all samples)."""
    import torch
    from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss

    rendered, vb = model.ray_query(_tested(model, o, d, extra), **query)
    loss = torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2)
    if "nablas_packed" in vb:
        return loss + 0.1 * eikonal_loss(vb["nablas_packed"],
                                         vb["ridx"] < o.shape[0])
    return loss + 0.1 * eikonal_loss(vb["nablas"])


def _fixed_loss(model, o, d, extra=None, draw=None, generator=None):
    """bench_render.py:199-203: MSE(rgb, |d|) of `nerf_ray_query_fixed`
    at N_SAMPLES_FIXED stratified samples a ray."""
    import torch
    from nr3d_lib_tpu_torch.graphics.nerf_ray_query import \
        nerf_ray_query_fixed
    from nr3d_lib_tpu_torch.graphics.raysample import uniform_draw

    if draw is None and generator is not None:
        draw = uniform_draw(generator)
    rendered, _ = nerf_ray_query_fixed(model, model.space,
                                       _tested(model, o, d),
                                       n_samples=N_SAMPLES_FIXED, draw=draw)
    return torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2)


def _forest_loss(model, o, d, extra=None, draw=None, generator=None):
    """examples/train_forest_street.py:121-127: MSE(rgb, |d|) + 0.01·the
    mean of (‖nablas‖ − 1)² over every packed slot, padding included."""
    import torch

    rendered, vb = model.ray_query(model.ray_test(o, d), draw=draw,
                                   generator=generator)
    eik = torch.mean((torch.linalg.norm(vb["nablas_packed"], dim=-1)
                      - 1.0) ** 2)
    return torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2) + \
        0.01 * eik


def _obj_loss(model, o, d, extra=None, draw=None, generator=None):
    """examples/train_neus_object.py:117-123 with target |d|: MSE(rgb) +
    0.03 · the mean of (‖nablas‖ − 1)² over every slab sample."""
    import torch

    rendered, vb = model.ray_query(model.ray_test(o, d), draw=draw,
                                   generator=generator)
    eik = torch.mean((torch.linalg.norm(vb["nablas"], dim=-1) - 1.0) ** 2)
    return torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2) + \
        OBJ_EIKONAL * eik


def _emer_loss(model, o, d, extra=None, draw=None, generator=None):
    """examples/train_dynamic_scene.py:116-124 with target |d|: MSE(rgb) +
    1e-3·the dynamic density's sparsity + 1e-4 each of the flow's
    smoothness and cycle residual and the shadow penalty."""
    import torch

    rendered, vb = model.ray_query(_tested(model, o, d, extra), draw=draw,
                                   generator=generator)
    return torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2) + \
        1e-3 * vb["reg_dynamic_sparsity"] + 1e-4 * (
            vb["reg_flow_smooth"] + vb["reg_flow_cycle"] + vb["reg_shadow"])


def _gen_loss(model, o, d, extra=None, draw=None, generator=None):
    """examples/train_generative_shapes.py:112-121 (and
    train_conditional_dynamic.py's) with target |d|: MSE(rgb) + 0.03·the
    mean eikonal over every slab sample + 1e-4·the latents' mean square."""
    import torch

    rendered, vb = model.ray_query(_tested(model, o, d, extra), draw=draw,
                                   generator=generator)
    eik = torch.mean((torch.linalg.norm(vb["nablas"], dim=-1) - 1.0) ** 2)
    z = model.autodecoder.get_latent(torch.arange(model.n_instances,
                                                  device=o.device))
    return torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2) + \
        GEN_EIKONAL * eik + GEN_PRIOR * torch.mean(z ** 2)


def _kernel_row(kernels, *, name, key, path, source, replaces, err, ms,
                plain_ms, bound, library_ms=None, **extra) -> None:
    kernels.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, key=key, path=path,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound[0], bound_by=bound[1],
                        library_ms=library_ms, **extra))


def _check(label: str, n: int, parts) -> float:
    """Print and require each (what, err, tol, why) of a kernel phase;
    returns the largest error."""
    print(f"[{label}] N={n}: max|kernel-plain| " + "; ".join(
        f"{what} {err:.3e} (tolerance {tol:.3e}: {why})"
        for what, err, tol, why in parts))
    for what, err, tol, _ in parts:
        _require(err <= tol, f"{label}: {what} disagrees with its plain "
                 f"version")
    return max(p[1] for p in parts)


def _err(a, b) -> float:
    return float((a - b).abs().max())


def _autograd_nablas(model, x01, prefix: str) -> dict:
    """The nablas by autograd through `forward_sdf` (the want_g encode
    forward, the encode backward with dL/dx) against `forward_sdf_nablas`
    (the nablas kernel) on the same points; returns the launches of the
    autograd path. `prefix` names the kernels (brick4 or brick)."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build

    x = (x01 * 2.0 - 1.0).detach()
    _build.LAUNCHES.clear()
    xr = x.clone().requires_grad_(True)
    (nab, ) = torch.autograd.grad(model.forward_sdf(xr)["sdf"].sum(), xr)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    with torch.no_grad():
        ref = model.forward_sdf_nablas(x)["nablas"]
    err = _err(nab, ref)
    tol = 1e-5 + 1e-4 * float(ref.abs().max())
    print(f"[{prefix} autograd nablas] {x.shape[0]} points: launches "
          f"{launches}; max|autograd - split| {err:.3e} (tolerance "
          f"{tol:.3e}: the encode backward's dL/dx and the nablas kernel "
          f"sum the same terms in another order)")
    _require(launches == {f"{prefix}_fwd_g": 1, f"{prefix}_bwd": 1},
             "the autograd nablas did not run want_g and the backward once")
    _require(err <= tol, "autograd and split nablas disagree")
    return launches


def _step_vs_cpu(model, cpu, o, d, cpu_render_s: float, label: str,
                 extra=None, loss=None,
                 budget_s: float = CPU_STEP_BUDGET_S,
                 loss_tol: float = 1e-4, grad_tol: float = 1e-2) -> None:
    """One step's loss and gradients on the card against the CPU port from
    the same weights and uniforms: the card's draws are recorded and
    replayed on the CPU; the loss within `loss_tol` relative, each
    gradient within `grad_tol` relative L2 (PERF.md §2's 1e-4 and 1e-2).
    The ray count is cut when the CPU step, estimated as 3× the CPU
    render of all rays, would exceed `budget_s`."""
    import torch
    from nr3d_lib_tpu_torch.bridge import to_jax_paths
    from nr3d_lib_tpu_torch.graphics.raysample import uniform_draw

    n_all = n = o.shape[0]
    while n > 256 and 3.0 * cpu_render_s * n / n_all > budget_s:
        n //= 2
    if n < n_all:
        print(f"[{label} step vs cpu] cut to {n} of {n_all} rays: the CPU "
              f"render of {n_all} rays took {cpu_render_s:.1f} s")
    draws, base = [], uniform_draw(
        torch.Generator(device=o.device).manual_seed(8))

    def record(shape, lo, hi):
        draws.append(base(shape, lo, hi))
        return draws[-1]

    def replay(shape, lo, hi):
        u = draws.pop(0).cpu()
        _require(tuple(u.shape) == tuple(shape), "replayed draw shape")
        return u

    loss = loss or _step_loss
    model.zero_grad(set_to_none=True)
    cpu.zero_grad(set_to_none=True)
    loss_g = loss(model, o[:n], d[:n], extra, draw=record)
    loss_g.backward()
    t0 = time.perf_counter()
    loss_c = loss(cpu, o[:n].cpu(), d[:n].cpu(), extra, draw=replay)
    loss_c.backward()
    cpu_step_s = time.perf_counter() - t0
    loss_g, loss_c = float(loss_g.detach()), float(loss_c.detach())
    rel_loss = abs(loss_g - loss_c) / abs(loss_c)
    gg = to_jax_paths({k: p.grad for k, p in model.named_parameters()})
    gc = to_jax_paths({k: p.grad for k, p in cpu.named_parameters()})
    errs = {k: float(np.linalg.norm(gg[k] - gc[k]) /
                     max(np.linalg.norm(gc[k]), 1e-12)) for k in gc}
    print(f"[{label} step vs cpu] {n} rays, CPU step {cpu_step_s:.1f} s: "
          f"loss card {loss_g:.7f} cpu {loss_c:.7f}, relative "
          f"{rel_loss:.2e} (tolerance {loss_tol:.2e}); gradients, relative "
          f"L2 per tensor (tolerance {grad_tol:.2e}: the render's discrete "
          f"choices move a few rays whole between routes, and atomics sum "
          f"in another order): max {max(errs.values()):.2e}")
    for k, e in sorted(errs.items()):
        print(f"[{label} step vs cpu]   {k}: {e:.3e}")
    _require(rel_loss <= loss_tol, "card and CPU step losses disagree")
    _require(max(errs.values()) <= grad_tol,
             "card and CPU gradients disagree")
    model.zero_grad(set_to_none=True)


def _train_state(model, device, lr: float = 5e-3):
    """The train steps' optimizer, Adam(lr), and their generator."""
    import torch

    return (torch.optim.Adam(model.parameters(), lr=lr),
            torch.Generator(device=device).manual_seed(9))


def _train_step(model, opt, gen, o, d, it: int, extra=None, loss_fn=None,
                lifecycle: bool = True, gated: bool = False,
                clip: float = None):
    """Train step `it` (1, 2, ...): lifecycle (the production step's; the
    bench's `main_train` steps of kind nerf and neus run none), loss,
    backward, Adam. `gated`: the lifecycle of examples/
    train_forest_street.py:140-147, `training_before_per_step` alone,
    every `lifecycle_update_every` steps (every step when the model has a
    stepwise schedule). `clip`: the gradients' global norm clipped to it
    before Adam, as `optax.clip_by_global_norm` does. Returns the loss,
    detached."""
    every = 1 if not gated or model.has_stepwise_schedules() else \
        model.lifecycle_update_every
    if lifecycle and it % every == 0:
        model.training_before_per_step(it, gen)
    opt.zero_grad(set_to_none=True)
    loss = (loss_fn or _step_loss)(model, o, d, extra, generator=gen)
    loss.backward()
    if clip is not None:
        from nr3d_lib_tpu_torch.models.utils import clip_by_global_norm_

        clip_by_global_norm_(model.parameters(), clip)
    opt.step()
    if lifecycle and not gated:
        model.training_after_per_step(it, gen)
    return loss.detach()


def _train(model, o, d, smi: str, label: str, per_step: dict,
           per_update: dict, extra=None, loss_fn=None,
           lifecycle: bool = True, lr: float = 5e-3,
           gated: bool = False, clip: float = None) -> dict:
    """A train step: warm-up, then N_STEPS timed steps that cross an
    occupancy update (with the lifecycle); each step must launch exactly
    `per_step`, plus `per_update` at an update. Returns the timed steps'
    launches."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build

    opt, gen = _train_state(model, o.device, lr)
    its = iter(range(1, 10 ** 6))
    losses = []

    def step():
        it = next(its)
        losses.append(_train_step(model, opt, gen, o, d, it, extra, loss_fn,
                                  lifecycle, gated, clip))
        return it

    for _ in range(N_WARMUP_STEPS):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    times, timed = [], []
    for _ in range(N_STEPS):
        t0 = time.perf_counter()
        timed.append(step())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    med = statistics.median(times)
    q1, _, q3 = statistics.quantiles(times, n=4)
    vals = [float(v) for v in losses]
    n_rays = o.shape[0]
    print(f"[{label} train] {n_rays} rays x {N_STEPS} steps (it {timed[0]}.."
          f"{timed[-1]}) on {smi}: median {med:.3f} ms/step (quartiles "
          f"{q1:.3f}/{q3:.3f}, min {min(times):.3f}, max {max(times):.3f}) "
          f"-> {n_rays / med:.1f} Krays/s | peak memory {peak_mib:.1f} MiB")
    print(f"[{label} train] loss per step: "
          f"{' '.join(f'{v:.6f}' for v in vals)}")
    print(f"[{label} train] launches in the {N_STEPS} timed steps: "
          f"{launches}")
    n_upd = sum(it % model.lifecycle_update_every == 0
                for it in timed) if lifecycle else 0
    expect = {k: v * N_STEPS + per_update.get(k, 0) * n_upd
              for k, v in per_step.items()}
    print(f"[{label} train] expected: {expect} ({per_step} per step + "
          f"{per_update} at each of the {n_upd} occupancy updates)")
    _require(launches == expect, "the train step's launches are not exact")
    _require(all(np.isfinite(vals)), "a loss is not finite")
    last5 = float(np.mean(vals[-5:]))
    print(f"[{label} train] mean loss of the last 5 steps {last5:.6f} vs the "
          f"first step's {vals[0]:.6f}")
    _require(last5 < vals[0], "the loss did not fall")
    _profile(step, med, f"{label} train step")
    return launches


def _record_step(model, o, d, it: int, module, names, loss_fn=None) -> dict:
    """One train step's loss and backward at iteration `it` (no optimizer
    step) with the wrappers `names` of `module` wrapped, so the inputs
    that each receives inside the step are kept: {name: its arguments by
    parameter name, tensors cloned}."""
    import inspect
    import torch

    rec, orig = {}, {n: getattr(module, n) for n in names}

    def keeper(name):
        sig = inspect.signature(orig[name])

        def keep(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            rec[name] = {k: v.clone() if isinstance(v, torch.Tensor) else v
                         for k, v in bound.arguments.items()}
            return orig[name](*args, **kw)
        return keep

    gen = torch.Generator(device=o.device).manual_seed(9)
    for name in names:
        setattr(module, name, keeper(name))
    try:
        model.training_before_per_step(it, gen)
        (loss_fn or _step_loss)(model, o, d, generator=gen).backward()
    finally:
        for name in names:
            setattr(module, name, orig[name])
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    _require(set(rec) == set(names), f"{sorted(set(names) - set(rec))} of "
             f"{module.__name__} not called in the train step")
    return rec


def _step_points(model, o, d, kernels, module, rows: dict) -> None:
    """The backward kernels `rows` ({wrapper of `module`: its kernel row's
    key}) on the inputs they receive in one more train step (after the
    timed ones): each one's time there, alone, and the atomics those
    points need; added to its row."""
    import torch
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    it = N_WARMUP_STEPS + N_STEPS + 1
    recs = _record_step(model, o, d, it, module, tuple(rows))
    for fn, key in rows.items():
        a = recs[fn]
        x, meta = a["x"], a["meta"]
        n, L = x.shape[0], meta.n_levels
        with torch.no_grad():
            ms = _time_ms(lambda: getattr(module, fn)(**a))
            groups = sum(B.brick_atomic_groups(x, meta))
        row = next(k for k in kernels if k["key"] == key)
        print(f"[{row['name']}] on the train step's own {n:,} points x {L} "
              f"levels (step it = {it}; need_dx {a['need_dx']}): kernel "
              f"{ms:.4f} ms alone | atomics {groups:,} of {n * L * 8:,} "
              f"after the warps' aggregation")
        row.update(ms_step_points=ms, n_step_points=n, step_points_it=it,
                   atomic_groups_step_points=groups,
                   atomics_naive_step_points=n * L * 8)


def _serve(model, cpu_model, o, d, per_render: dict, label: str, smi: str,
           n_renders: int = N_RENDERS, extra=None, cpu_rays=None,
           tol: float = 1e-4):
    """Timed renders under no_grad with exact launches per render, all
    outputs finite, a device profile, and the same rays rendered by the
    CPU port: ≥ 99% of rays must agree within `tol` (1e-4) in rgb and
    depth (`cpu_rays`: only the first that many, rendered alone on the
    CPU; the render treats each ray alone). Returns (launches, seconds of
    the CPU render)."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build

    n_rays = o.shape[0]

    def render():
        return model.ray_query(_tested(model, o, d, extra))

    with torch.no_grad():
        render()                                            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        times = []
        for _ in range(n_renders):
            t0 = time.perf_counter()
            rendered, vb = render()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.LAUNCHES)
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        med = statistics.median(times)
        quart = ""
        if n_renders > 1:
            q1, _, q3 = statistics.quantiles(times, n=4)
            quart = f" (quartiles {q1:.3f}/{q3:.3f}, min {min(times):.3f}, " \
                f"max {max(times):.3f})"
        slots = vb["valid"] if "valid" in vb else vb.get("ridx")
        compact = f" | n_compact {int(vb['n_compact'])} of " \
            f"{slots.numel()} slots" if "n_compact" in vb else ""
        print(f"[{label}] {n_rays} rays x {n_renders} renders on {smi}: "
              f"median {med:.3f} ms/render{quart} -> {n_rays / med:.1f} "
              f"Krays/s | peak memory {peak_mib:.1f} MiB{compact}")
        print(f"[{label}] launches in the {n_renders} timed renders: "
              f"{launches}")
        expect = {k: v * n_renders for k, v in per_render.items()}
        _require(launches == expect, f"{label}: launches {launches}, "
                 f"expected {expect}")
        for k, v in rendered.items():
            _require(bool(torch.isfinite(v).all()), f"{k} is not finite")
        mask_mean = float(rendered["mask_volume"].mean())
        print(f"[{label}] all outputs finite; mean mask_volume "
              f"{mask_mean:.4f}")
        _require(mask_mean > 0.1, "the render is trivially empty")
        _profile(render, med, label)

        if hasattr(model, "ray_query_cfg"):
            cpu_model.ray_query_cfg = dict(model.ray_query_cfg)
        n_cpu = cpu_rays or n_rays
        if n_cpu < n_rays:
            print(f"[{label}] the CPU comparison keeps the first {n_cpu} of "
                  f"the {n_rays} rays (CPU_STEP_BUDGET_S)")
        t0 = time.perf_counter()
        r_cpu, _ = cpu_model.ray_query(_tested(
            cpu_model, o[:n_cpu].cpu(), d[:n_cpu].cpu(), extra))
        cpu_s = time.perf_counter() - t0
    ok = torch.ones(n_cpu, dtype=torch.bool)
    errs = []
    for k in ("rgb_volume", "depth_volume"):
        e = (rendered[k][:n_cpu].cpu() - r_cpu[k]).abs().reshape(n_cpu, -1)
        e = e.amax(-1)
        errs.append(e)
        ok &= e <= tol
    e_max = torch.stack(errs).amax(0)
    share = float(ok.float().mean())
    print(f"[{label}] GPU vs CPU port ({n_cpu} of {n_rays} rays, "
          f"{cpu_s:.1f} s on the CPU): {share * 100:.2f}% of rays agree "
          f"within {tol:.3e} on rgb and depth "
          f"({float((e_max <= 10 * tol).float().mean()) * 100:.2f}% within "
          f"{10 * tol:.3e}; max {float(e_max.max()):.3e})")
    _require(share >= 0.99, f"{label}: GPU and CPU renders disagree")
    return launches, cpu_s


def _render_fwd_calls(model, o, d, module, fn: str = "_fwd_cuda") -> list:
    """The arguments of each launch of `module.<fn>` (the forward encode by
    default) in one render of `model`, outside the counted renders:
    [(args, kw)]."""
    import torch

    calls, fwd = [], getattr(module, fn)

    def recording(*args, **kw):
        calls.append((args, kw))
        return fwd(*args, **kw)

    setattr(module, fn, recording)
    try:
        with torch.no_grad():
            model.ray_query(_tested(model, o, d))
        torch.cuda.synchronize()
    finally:
        setattr(module, fn, fwd)
    return calls


def _launch_sizes(model, o, d, module, tag: str, kernels, key: str
                  ) -> None:
    """Points of each forward-encode launch (`module._fwd_cuda`) in one
    render of `model`, printed on a `[tag launches]` line; their sum
    against the kernel row's N weighs the row's time by what a render
    runs. Where the row holds each launch's own time (B6), the render's
    time over the bound is their sum instead."""
    sizes = [int(a[0].shape[0]) for a, _ in _render_fwd_calls(model, o, d,
                                                                module)]
    row = next(k for k in kernels if k["key"] == key)
    n_row = row.get("n_points_neus_render", row["n_points"])
    ms = row.get("ms_neus_render", row["ms"])
    bound = row.get("bound_ms_neus_render", row["bound_ms"])
    share = sum(sizes) / n_row
    over = share * (ms - bound)
    how = f"weight {share:.4f} x ({ms:.4f} - {bound:.4f})"
    if "ms_by_launch_render" in row:
        _require(sizes == row["n_points_by_launch_render"], f"{tag}: the "
                 f"render's launches differ from the kernel phase's")
        over = sum(t - b for t, b in zip(row["ms_by_launch_render"],
                                         row["bound_ms_by_launch_render"]))
        how = (f"each launch's own time less its bound, summed (weight "
               f"{share:.4f} x the row's would give {share * (ms - bound):.4f}"
               f")")
    print(f"[{tag} launches] one render: {len(sizes)} launches of "
          f"{', '.join(f'{s:,}' for s in sizes)} points, {sum(sizes):,} in "
          f"all = {share:.4f} x the row's N={n_row:,}; {how} = {over:.4f} "
          f"ms over the bound a render")
    row["n_points_by_launch_render"] = sizes
    row["weight_ms_render"] = over


def _f4_kernel_phases(model, o, d, kernels) -> "torch.Tensor":
    """Slices 1 and 2: B1, B3, B5 at the serving render's shapes; B1 want_g,
    B2 and B4 at the train step's. Returns the step's 147,456 points."""
    import torch
    from nr3d_lib_tpu_torch.ops import gather1d as G
    from nr3d_lib_tpu_torch.ops import lotd_brick as B
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4
    from nr3d_lib_tpu_torch.ops import occgrid_march as OM

    src = "nr3d_lib_tpu_torch/csrc/brick4.cu"
    rep = "nr3d_lib_tpu/ops/lotd_brick4.py"
    dev = o.device
    enc = model.field.implicit_surface.encoding
    meta = enc.meta
    with torch.no_grad():
        table = enc._build_table()
        packed = B4.pack_table4(table)
        table_bytes = packed.numel() * 4
        L = meta.n_levels

        # ------------------------------------------------ B1 brick4_fwd
        x1 = _ray_points(o, d, 144, seed=2)              # 589,824 points
        n = x1.shape[0]
        y_p = B4.brick4_encode_xla(x1, table, meta)
        err = _check(f"B1 brick4_fwd, L={L}", n, [(
            "y", _err(B4.brick4_encode(x1, table, meta), y_p),
            1e-5 + 1e-5 * float(y_p.abs().max()),
            "8-term sums in another order")])
        ms = _time_ms(lambda: B4._fwd_cuda(x1, packed, meta))
        plain_ms = _time_ms(lambda: B4.brick4_encode_xla(x1, table, meta),
                            iters=5)
        # each (point, level): 8 corners × (2 weight muls + 4 FMAs) + 3 axes
        # × 4 (scale, offset, floor, frac) → 92 float ops
        bound = _bound(n * (12 + 16 * L) + table_bytes, n * L * 92)
        print(f"[B1 brick4_fwd] kernel {ms:.4f} ms | plain {plain_ms:.4f} ms"
              f" | bound {bound[0]:.4f} ms ({bound[1]}) | library: none")
        _kernel_row(kernels, name="brick4_fwd (B1)", key="brick4_fwd",
                    path="f4 render", source=src, replaces=f"{rep}:172",
                    err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                    n_points=n)

        # ----------------------------------------------- B3 brick4_dydx
        x3 = _ray_points(o, d, 36, seed=3)               # 147,456 points
        n = x3.shape[0]
        g3 = torch.randn(n, 4 * L, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
        n_p = B4.brick4_nablas_xla(g3, x3, table, meta)
        err = _check("B3 brick4_dydx", n, [(
            "nablas", _err(B4.brick4_nablas(g3, x3, table, meta), n_p),
            1e-4 + 1e-4 * float(n_p.abs().max()),
            f"sums over 8 corners × 4 feats × {L} levels, scaled by res-2, "
            f"in another order")])
        ms = _time_ms(lambda: B4._dydx_cuda(g3, x3, packed, meta))
        plain_ms = _time_ms(lambda: B4.brick4_nablas_xla(g3, x3, table, meta),
                            iters=5)
        bound = _b3_bound(n, L, table_bytes)
        print(f"[B3 brick4_dydx] kernel {ms:.4f} ms | plain {plain_ms:.4f} "
              f"ms | bound {bound[0]:.4f} ms ({bound[1]}) | library: none")
        _kernel_row(kernels, name="brick4_dydx (B3)", key="brick4_dydx",
                    path="f4 render", source=src, replaces=f"{rep}:803",
                    err=err, ms=ms, plain_ms=plain_ms, bound=bound)

        # ---------------------------------------------------- B5 gather1d
        rt = model.ray_test(o, d)
        o_n, d_n = model.space.normalize_rays(o, d)
        t5, _, _ = OM.march_steps(rt["near"], rt["far"], 96, 2.0 / 96)
        xs = [o_n[:, None, a] + d_n[:, None, a] * t5 for a in range(3)]
        row, lane, _ = OM.grid_rows_lanes((64, 64, 64), *xs)
        row, lane = row.reshape(-1).contiguous(), lane.reshape(-1).contiguous()
        values = model.accel.occ.occ().reshape(4096, 64).to(torch.float32)
        n = row.numel()
        err = _check(f"B5 gather1d, table {tuple(values.shape)}", n, [(
            "values", _err(G.gather_rows_lanes(values, row, lane),
                           G.gather_rows_lanes_plain(values, row, lane)),
            0.0, "a copy")])
        ms = _time_ms(lambda: G.gather_rows_lanes(values, row, lane))
        plain_ms = _time_ms(
            lambda: G.gather_rows_lanes_plain(values, row, lane))
        rl, ll = row.long(), lane.long()
        library_ms = _time_ms(lambda: values[rl, ll])
        bound = _bound(n * 12 + values.numel() * 4, 0)
        print(f"[B5 gather1d] kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
              f"values[row, lane] {library_ms:.4f} ms | bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
        # launches counted where B5 still runs: the compressed queries
        # march with occ_march_budget, the dense mode march_occ with B5
        _kernel_row(kernels, name="gather1d (B5)", key="gather1d",
                    path="nerf_w4_serve_8192 march_occ",
                    source="nr3d_lib_tpu_torch/csrc/gather1d.cu",
                    replaces="nr3d_lib_tpu/ops/gather1d.py:30", err=err,
                    ms=ms, plain_ms=plain_ms, bound=bound,
                    library_ms=library_ms)

        # --------------------- training kernels at the step's 147,456 points
        n = x3.shape[0]
        gen_k = torch.Generator(device=dev).manual_seed(6)
        g2 = torch.randn(n, 4 * L, device=dev, generator=gen_k)
        gg4 = torch.randn(n, 3, device=dev, generator=gen_k)
        dtab_bytes = meta.total_rows * 256 * 4       # the zeroed f32 output

        # B1 with want_g: y and the corner words B2 reads back for dL/dx
        perm = torch.randperm(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(7))
        xp2, gp2, ggp4 = (v[perm].contiguous() for v in (x3, g2, gg4))
        y_k, words = B4._fwd_cuda(x3, packed, meta, want_g=True)
        y_p = B4.brick4_encode_xla(x3, table, meta)
        words_ok = bool(torch.equal(
            words, B4.brick4_corner_words_xla(x3, table, meta)))
        err = _check("B1 want_g brick4_fwd_g", n, [
            ("y", _err(y_k, y_p), 1e-5 + 1e-5 * float(y_p.abs().max()),
             "as B1"),
            ("corner words", 0.0 if words_ok else float("inf"), 0.0,
             "a copy")])
        # a (point, level) computes alone: the same bits in another order
        # of the points
        y_perm, words_perm = B4._fwd_cuda(xp2, packed, meta, want_g=True)
        _require(torch.equal(y_perm, y_k[perm]) and
                 torch.equal(words_perm, words[perm]),
                 "B1 want_g: a point's y or words depend on its place in "
                 "the batch")
        ms = _time_ms(lambda: B4._fwd_cuda(x3, packed, meta, want_g=True))
        ms_perm = _time_ms(lambda: B4._fwd_cuda(xp2, packed, meta,
                                                want_g=True))
        plain_ms = _time_ms(lambda: (
            B4.brick4_encode_xla(x3, table, meta),
            B4.brick4_corner_words_xla(x3, table, meta)), iters=5)
        bound = _b1_want_g_bound(n, L, table_bytes)
        print(f"[B1 want_g brick4_fwd_g] kernel {ms:.4f} ms (the same "
              f"points permuted: {ms_perm:.4f} ms, bitwise the same y and "
              f"words) | plain {plain_ms:.4f} ms | bound {bound[0]:.4f} ms "
              f"({bound[1]}) | library: none")
        _kernel_row(kernels, name="brick4_fwd want_g (B1)",
                    key="brick4_fwd_g", path="f4 autograd nablas",
                    source=src, replaces=f"{rep}:172", err=err, ms=ms,
                    plain_ms=plain_ms, bound=bound, ms_permuted=ms_perm)

        # B2: dL/dtable by float4 atomics; dL/dx from the want_g words
        dx_p, dtab_p = B4.brick4_encode_bwd_xla(x3, table, g2, meta, True)
        _, dtab_k = B4._bwd_cuda(x3, g2, meta, need_dx=False)
        dx_k, dtab_k2 = B4._bwd_cuda(x3, g2, meta, need_dx=True, words=words)
        err = _check("B2 brick4_bwd", n, [
            ("dL/dtable", max(_err(dtab_k, dtab_p), _err(dtab_k2, dtab_p)),
             1e-6 + 1e-5 * float(dtab_p.abs().max()),
             "~150 terms per dense slot summed by atomics in an order that "
             "changes from run to run"),
            ("dL/dx", _err(dx_k, dx_p), 1e-4 + 1e-4 * float(dx_p.abs().max()),
             "sums over corners, feats and levels scaled by res-2")])
        # dL/dx is each point's own level sum: the same bits in another
        # order of the points
        dx_perm, _ = B4._bwd_cuda(xp2, gp2, meta, need_dx=True,
                                  words=B4._fwd_cuda(xp2, packed, meta,
                                                     want_g=True)[1])
        _require(torch.equal(dx_perm, dx_k[perm]), "B2: a point's dL/dx "
                 "depends on its place in the batch")
        ms = _time_ms(lambda: B4._bwd_cuda(x3, g2, meta, need_dx=False))
        ms_dx = _time_ms(lambda: B4._bwd_cuda(x3, g2, meta, need_dx=True,
                                              words=words))
        ms_perm = _time_ms(lambda: B4._bwd_cuda(xp2, gp2, meta,
                                                need_dx=False))
        plain_ms = _time_ms(lambda: B4.brick4_encode_bwd_xla(
            x3, table, g2, meta, False), iters=5)
        plain_dx = _time_ms(lambda: B4.brick4_encode_bwd_xla(
            x3, table, g2, meta, True), iters=5)
        # float4 atomics: one a (point, level, corner), and what the warps'
        # aggregation leaves at ray order (B2 and B4 scatter the same keys)
        naive = n * L * 8
        groups = sum(B.brick_atomic_groups(x3, meta))
        # each (point, level): 12 index ops + 8 corners × (2 weight muls +
        # 4 products + 4 adds) = 92; with dL/dx + 8 × (7 for g·val + 9)
        bound = _bound(n * (12 + 16 * L) + dtab_bytes, n * L * 92)
        bound_dx = _bound(n * (12 + 16 * L + 64 * L + 12) + dtab_bytes,
                          n * L * (92 + 128))
        print(f"[B2 brick4_bwd] need_dx false (the step's form): kernel "
              f"{ms:.4f} ms (permuted {ms_perm:.4f} ms) | plain "
              f"{plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]}); "
              f"need_dx true: kernel {ms_dx:.4f} ms | plain {plain_dx:.4f} "
              f"ms | bound {bound_dx[0]:.4f} ms ({bound_dx[1]}) | library: "
              f"none | float4 atomics {groups:,} of {naive:,} after the "
              f"warps' aggregation")
        _kernel_row(kernels, name="brick4_bwd (B2)", key="brick4_bwd",
                    path="f4 train step", source=src, replaces=f"{rep}:380",
                    err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                    ms_need_dx=ms_dx, plain_ms_need_dx=plain_dx,
                    bound_ms_need_dx=bound_dx[0], ms_permuted=ms_perm,
                    atomics_naive=naive, atomic_groups=groups)

        # B4: the nablas' backward
        dg_p, dx4_p, dt4_p = B4.brick4_nablas_bwd_xla(g2, x3, table, gg4,
                                                      meta)
        dg_k, dx4_k, dt4_k = B4._bwd2_cuda(g2, x3, packed, gg4, meta)
        _, none_dx, dt4_k2 = B4._bwd2_cuda(g2, x3, packed, gg4, meta,
                                           need_dx=False)
        _require(none_dx is None, "B4 wrote dL/dx without need_dx")
        err = _check("B4 brick4_bwd2", n, [
            ("dL/dg_up", _err(dg_k, dg_p),
             1e-4 + 1e-4 * float(dg_p.abs().max()),
             "sums over corners scaled by res-2 in another order"),
            ("dL/dx", _err(dx4_k, dx4_p),
             1e-4 + 1e-4 * float(dx4_p.abs().max()),
             "sums over corners scaled by (res-2)^2 in another order"),
            ("dL/dtable", max(_err(dt4_k, dt4_p), _err(dt4_k2, dt4_p)),
             1e-6 + 1e-5 * float(dt4_p.abs().max()),
             "atomics, order changes from run to run")])
        # dL/dg_up and dL/dx are each point's own sums: the same bits in
        # another order of the points
        dg_perm, dx4_perm, _ = B4._bwd2_cuda(gp2, xp2, packed, ggp4, meta)
        _require(torch.equal(dg_perm, dg_k[perm]) and
                 torch.equal(dx4_perm, dx4_k[perm]),
                 "B4: a point's dL/dg_up or dL/dx depends on its place in "
                 "the batch")
        ms = _time_ms(lambda: B4._bwd2_cuda(g2, x3, packed, gg4, meta,
                                            need_dx=False))
        ms_dx = _time_ms(lambda: B4._bwd2_cuda(g2, x3, packed, gg4, meta))
        ms_perm = _time_ms(lambda: B4._bwd2_cuda(gp2, xp2, packed, ggp4,
                                                 meta, need_dx=False))
        plain_ms = _time_ms(lambda: B4.brick4_nablas_bwd_xla(
            g2, x3, table, gg4, meta), iters=5)
        # each (point, level): 18 index/scale ops + 8 corners × (11 for c_k
        # + 8 for dL/dg_up + 8 for dL/dtable) = 234; dL/dx + 8 × 25
        io = n * (16 * L + 12 + 12 + 16 * L) + table_bytes + dtab_bytes
        bound = _bound(io, n * L * 234)
        bound_dx = _bound(io + n * 12, n * L * 434)
        print(f"[B4 brick4_bwd2] need_dx false (the step's form): kernel "
              f"{ms:.4f} ms (permuted {ms_perm:.4f} ms) | bound "
              f"{bound[0]:.4f} ms ({bound[1]}); need_dx true: kernel "
              f"{ms_dx:.4f} ms | bound {bound_dx[0]:.4f} ms "
              f"({bound_dx[1]}); plain (all three gradients) {plain_ms:.4f}"
              f" ms | library: none | float4 atomics {groups:,} of "
              f"{naive:,} after the warps' aggregation")
        _kernel_row(kernels, name="brick4_bwd2 (B4)", key="brick4_bwd2",
                    path="f4 train step", source=src, replaces=f"{rep}:875",
                    err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                    ms_need_dx=ms_dx, bound_ms_need_dx=bound_dx[0],
                    ms_permuted=ms_perm, atomics_naive=naive,
                    atomic_groups=groups)
    return x3


def _occ_march_phase(dev, kernels) -> None:
    """The fused march and first budget compaction (`occ_march_budget`,
    `csrc/occ_march.cu`) at both benchmark cells' marches
    (`tests/torch_march_cells.py`): t, dt and valid bitwise the dense
    route's on the card (`occgrid_march_dense`, the ray mask,
    `dense_to_budgeted`), the kernel timed beside that route and its
    bound (each ray's inputs and [B] outputs once, the grid and the step
    tables once)."""
    import torch
    from nr3d_lib_tpu_torch.graphics.pack_ops import dense_to_budgeted
    from nr3d_lib_tpu_torch.ops import _build
    from nr3d_lib_tpu_torch.ops import occgrid_march as OM
    from torch.autograd import DeviceType

    sys.path.insert(0, str(REPO / "tests"))
    try:
        import torch_march_cells as MC
    finally:
        sys.path.remove(str(REPO / "tests"))

    for name in MC.CELLS:
        c = MC.cell(name, dev, seed=5)
        occ, mask, u, b = c["occ"], c["ray_mask"], c["u"], c["budget"]
        args = (occ, c["o"], c["d"], c["near"], c["far"])
        kw = dict(n_steps=c["n_steps"], step_size=c["step_size"], u=u)

        def fused():
            return OM.occgrid_march_budgeted(*args, **kw, budget=b,
                                             ray_mask=mask)

        def dense():
            t, dt, m = OM.occgrid_march_dense(*args, **kw)
            if mask is not None:
                m = m & mask[:, None]
            (t, dt), valid = dense_to_budgeted([t, dt], m, b)
            return t, dt, valid

        before = _build.LAUNCHES["occ_march_budget"]
        got, want = fused(), dense()
        torch.cuda.synchronize()
        _require(_build.LAUNCHES["occ_march_budget"] == before + 1,
                 f"{name}: one occ_march_budget launch")
        same = all(torch.equal(a, w) for a, w in zip(got, want))
        _require(same, f"{name}: the fused march is not the dense route's "
                 f"bits")
        r = c["o"].shape[0]
        ms = _time_ms(fused)
        plain_ms = _time_ms(dense)
        events = sum(ev.count for ev in _profiled(dense, 1).key_averages()
                     if ev.device_type == DeviceType.CUDA
                     and "spin_kernel" not in ev.key)
        n_bytes = (r * (24 + 8 + (mask is not None)) + r * b * 9 +
                   occ.numel() + 8 * c["n_steps"] +
                   (0 if u is None else u.numel() * 4))
        bound = _bound(n_bytes, 0)
        kept = float(want[2].sum(-1).float().mean())
        print(f"[occ_march_budget] {name}: {r:,} rays, S={c['n_steps']}, "
              f"B={b}, {kept:.3f} kept a ray; t, dt, valid bitwise the "
              f"dense route's; kernel {ms:.4f} ms | the dense route "
              f"{plain_ms:.4f} ms in {events} device events | bound "
              f"{bound[0]:.4f} ms ({bound[1]}, {n_bytes / 1e6:.1f} MB)")
        _kernel_row(kernels, name=f"occ_march_budget ({name})",
                    key="occ_march_budget", path="f4 render",
                    source="nr3d_lib_tpu_torch/csrc/occ_march.cu",
                    replaces="nr3d_lib_tpu/ops/gather1d.py:30 + "
                             "occgrid_march.py + pack_ops.dense_to_budgeted",
                    err=0.0, ms=ms, plain_ms=plain_ms, bound=bound,
                    plain_events=events)


def _f2_kernel_phases(nerf, neus, o8, d8, o, d, kernels) -> "torch.Tensor":
    """Slice 3: B6 at the NeRF render's and the NeuS render's shapes; B6
    want_g, B7, B8 and B9 at the NeuS train step's 147,456 points × 4
    levels. Returns those points."""
    import torch
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    src = "nr3d_lib_tpu_torch/csrc/brick.cu"
    rep = "nr3d_lib_tpu/ops/lotd_brick.py"
    dev = o.device
    with torch.no_grad():
        # ------------------------------------------------- B6 brick_fwd
        shapes = []
        for what, enc, x in (
                ("NeRF render", nerf.field.encoding,
                 _ray_points(o8, d8, 24, seed=12)),        # 196,608 points
                ("NeuS render", neus.field.implicit_surface.encoding,
                 _ray_points(o, d, 144, seed=13))):        # 589,824 points
            meta, table = enc.meta, enc._build_table()
            n, L = x.shape[0], meta.n_levels
            y_p = B.brick_encode_xla(x, table, meta)
            err = _check(f"B6 brick_fwd, {what}, L={L}", n, [(
                "y", _err(B.brick_encode(x, table, meta), y_p),
                1e-5 + 1e-5 * float(y_p.abs().max()),
                "8-term sums in another order")])
            ms = _time_ms(lambda: B._fwd_cuda(x, table, meta))
            plain_ms = _time_ms(lambda: B.brick_encode_xla(x, table, meta),
                                iters=5)
            bound = _b6_bound(n, L, table.numel())
            print(f"[B6 brick_fwd, {what}] kernel {ms:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]})"
                  f" | library: none")
            shapes.append(dict(n=n, levels=L, err=err, ms=ms,
                               plain_ms=plain_ms, bound=bound))
        # on the inputs of each of its launches in one F=2 NeuS render
        # (outside the counted renders): `[B6 launches]` sums their times
        by_launch = []
        for k, (args, kw) in enumerate(_render_fwd_calls(neus, o, d, B)):
            x, table, meta = args[:3]
            n, L = x.shape[0], meta.n_levels
            ms = _time_ms(lambda: B._fwd_cuda(*args, **kw))
            bound = _b6_bound(n, L, table.numel())
            print(f"[B6 brick_fwd, NeuS render launch {k}] {n:,} points x "
                  f"{L} levels: kernel {ms:.4f} ms | bound {bound[0]:.4f} ms "
                  f"({bound[1]})")
            by_launch.append((n, ms, bound[0]))
        a, b = shapes
        _kernel_row(kernels, name="brick_fwd (B6)", key="brick_fwd",
                    path="nerf render", source=src, replaces=f"{rep}:440",
                    err=max(a["err"], b["err"]), ms=a["ms"],
                    plain_ms=a["plain_ms"], bound=a["bound"], n_points=a["n"],
                    ms_neus_render=b["ms"], plain_ms_neus_render=b["plain_ms"],
                    bound_ms_neus_render=b["bound"][0],
                    n_points_neus_render=b["n"],
                    n_points_by_launch_render=[t[0] for t in by_launch],
                    ms_by_launch_render=[t[1] for t in by_launch],
                    bound_ms_by_launch_render=[t[2] for t in by_launch])

        # ------------------ the NeuS train step's shapes (147,456 × 4)
        enc = neus.field.implicit_surface.encoding
        meta, table = enc.meta, enc._build_table()
        x3 = _ray_points(o, d, 36, seed=14)
        n, L = x3.shape[0], meta.n_levels
        gen = torch.Generator(device=dev).manual_seed(15)
        g2 = torch.randn(n, 2 * L, device=dev, generator=gen)
        gg = torch.randn(n, 3, device=dev, generator=gen)
        tab_bytes = table.numel() * 4      # = the zeroed f32 gradient's

        # B6 want_g: y and the corner values B7 reads back for dL/dx
        y_k, corners = B._fwd_cuda(x3, table, meta, want_g=True)
        y_p = B.brick_encode_xla(x3, table, meta)
        c_ok = bool(torch.equal(corners,
                                B.brick_corner_values_xla(x3, table, meta)))
        err = _check("B6 want_g brick_fwd_g", n, [
            ("y", _err(y_k, y_p), 1e-5 + 1e-5 * float(y_p.abs().max()),
             "as B6"),
            ("corner values", 0.0 if c_ok else float("inf"), 0.0,
             "a copy")])
        ms = _time_ms(lambda: B._fwd_cuda(x3, table, meta, want_g=True))
        plain_ms = _time_ms(lambda: (
            B.brick_encode_xla(x3, table, meta),
            B.brick_corner_values_xla(x3, table, meta)), iters=5)
        bound = _b6_bound(n, L, table.numel(), want_g=True)
        print(f"[B6 want_g brick_fwd_g] kernel {ms:.4f} ms | plain "
              f"{plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]}) | "
              f"library: none")
        _kernel_row(kernels, name="brick_fwd want_g (B6)", key="brick_fwd_g",
                    path="f2 autograd nablas", source=src,
                    replaces=f"{rep}:440", err=err, ms=ms, plain_ms=plain_ms,
                    bound=bound)

        # B7: dL/dtable by the warps' aggregated float2 atomics; dL/dx from
        # the want_g corners, summed over the levels in the block
        dx_p, dtab_p = B.brick_encode_bwd_xla(x3, table, g2, meta, True)
        _, dtab_k = B._bwd_cuda(x3, g2, meta, need_dx=False)
        dx_k, dtab_k2 = B._bwd_cuda(x3, g2, meta, need_dx=True,
                                    corners=corners)
        err = _check("B7 brick_bwd", n, [
            ("dL/dtable", max(_err(dtab_k, dtab_p), _err(dtab_k2, dtab_p)),
             1e-6 + 1e-5 * float(dtab_p.abs().max()),
             "hundreds of terms per dense slot summed by atomics in an "
             "order that changes from run to run"),
            ("dL/dx", _err(dx_k, dx_p), 1e-4 + 1e-4 * float(dx_p.abs().max()),
             "sums over corners, features and levels scaled by res-2")])
        # dL/dx is each point's own level sum: the same bits in another
        # order of the points
        perm = torch.randperm(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(17))
        xp7, gp7 = x3[perm].contiguous(), g2[perm].contiguous()
        dx_perm, _ = B._bwd_cuda(xp7, gp7, meta, need_dx=True,
                                 corners=B._fwd_cuda(xp7, table, meta,
                                                     want_g=True)[1])
        _require(torch.equal(dx_perm, dx_k[perm]), "B7: a point's dL/dx "
                 "depends on its place in the batch")
        ms = _time_ms(lambda: B._bwd_cuda(x3, g2, meta, need_dx=False))
        ms_dx = _time_ms(lambda: B._bwd_cuda(x3, g2, meta, need_dx=True,
                                             corners=corners))
        ms_perm = _time_ms(lambda: B._bwd_cuda(xp7, gp7, meta,
                                               need_dx=False))
        plain_ms = _time_ms(lambda: B.brick_encode_bwd_xla(
            x3, table, g2, meta, False), iters=5)
        plain_dx = _time_ms(lambda: B.brick_encode_bwd_xla(
            x3, table, g2, meta, True), iters=5)
        naive = n * L * 8
        groups = sum(B.brick_atomic_groups(x3, meta))
        # each (point, level): 12 index ops + 8 corners × (2 weight muls +
        # 2 products) = 44; with dL/dx + 8 × (3 for g·val + 9) = 140
        bound = _bound(n * (12 + 8 * L) + tab_bytes, n * L * 44)
        bound_dx = _bound(n * (12 + 8 * L + 64 * L + 12) + tab_bytes,
                          n * L * 140)
        print(f"[B7 brick_bwd] need_dx false (the step's form): kernel "
              f"{ms:.4f} ms (permuted {ms_perm:.4f} ms) | plain "
              f"{plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]}); "
              f"need_dx true: kernel {ms_dx:.4f} ms | plain {plain_dx:.4f} "
              f"ms | bound {bound_dx[0]:.4f} ms ({bound_dx[1]}) | library: "
              f"none | float2 atomics {groups:,} of {naive:,} after the "
              f"warps' aggregation")
        _kernel_row(kernels, name="brick_bwd (B7)", key="brick_bwd",
                    path="f2 train step", source=src, replaces=f"{rep}:787",
                    err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                    ms_need_dx=ms_dx, plain_ms_need_dx=plain_dx,
                    bound_ms_need_dx=bound_dx[0], ms_permuted=ms_perm,
                    atomics_naive=naive, atomic_groups=groups)

        # B8: the nablas
        n_p = B.brick_nablas_xla(g2, x3, table, meta)
        err = _check("B8 brick_dydx", n, [(
            "nablas", _err(B.brick_nablas(g2, x3, table, meta), n_p),
            1e-4 + 1e-4 * float(n_p.abs().max()),
            f"sums over 8 corners × 2 feats × {L} levels, scaled by res-2, "
            f"in another order")])
        # B8 sums each point's levels in its block: the same bits in
        # another order of the points
        perm = torch.randperm(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(18))
        xp8, gp8 = x3[perm].contiguous(), g2[perm].contiguous()
        _require(torch.equal(B._dydx_cuda(gp8, xp8, table, meta),
                             B._dydx_cuda(g2, x3, table, meta)[perm]),
                 "B8: a point's nablas depend on its place in the batch")
        ms = _time_ms(lambda: B._dydx_cuda(g2, x3, table, meta))
        ms_perm = _time_ms(lambda: B._dydx_cuda(gp8, xp8, table, meta))
        plain_ms = _time_ms(lambda: B.brick_nablas_xla(g2, x3, table, meta),
                            iters=5)
        bound = _b8_bound(n, L, tab_bytes)
        print(f"[B8 brick_dydx] kernel {ms:.4f} ms (the same points "
              f"permuted: {ms_perm:.4f} ms, bitwise the same nablas) | plain "
              f"{plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]}) | "
              f"library: none")
        _kernel_row(kernels, name="brick_dydx (B8)", key="brick_dydx",
                    path="f2 render", source=src, replaces=f"{rep}:992",
                    err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                    ms_permuted=ms_perm)

        # B9: the nablas' backward
        dg_p, dx_p, dt_p = B.brick_nablas_bwd_xla(g2, x3, table, gg, meta)
        dg_k, dx_k, dt_k = B._bwd2_cuda(g2, x3, table, gg, meta)
        _, none_dx, dt_k2 = B._bwd2_cuda(g2, x3, table, gg, meta,
                                         need_dx=False)
        _require(none_dx is None, "B9 wrote dL/dx without need_dx")
        err = _check("B9 brick_bwd2", n, [
            ("dL/dg_up", _err(dg_k, dg_p),
             1e-4 + 1e-4 * float(dg_p.abs().max()),
             "sums over corners scaled by res-2 in another order"),
            ("dL/dx", _err(dx_k, dx_p), 1e-4 + 1e-4 * float(dx_p.abs().max()),
             "sums over corners scaled by (res-2)^2 in another order"),
            ("dL/dtable", max(_err(dt_k, dt_p), _err(dt_k2, dt_p)),
             1e-6 + 1e-5 * float(dt_p.abs().max()),
             "atomics, order changes from run to run")])
        # dL/dg_up and dL/dx are each point's own sums: the same bits in
        # another order of the points
        perm = torch.randperm(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(16))
        xp_, gp_, ggp_ = (v[perm].contiguous() for v in (x3, g2, gg))
        dg_perm, dx_perm, _ = B._bwd2_cuda(gp_, xp_, table, ggp_, meta)
        _require(torch.equal(dg_perm, dg_k[perm]) and
                 torch.equal(dx_perm, dx_k[perm]),
                 "B9: a point's dL/dg_up or dL/dx depends on its place in "
                 "the batch")
        ms = _time_ms(lambda: B._bwd2_cuda(g2, x3, table, gg, meta,
                                           need_dx=False))
        ms_dx = _time_ms(lambda: B._bwd2_cuda(g2, x3, table, gg, meta))
        ms_perm = _time_ms(lambda: B._bwd2_cuda(gp_, xp_, table, ggp_, meta,
                                                need_dx=False))
        # float2 atomics: one a (point, level, corner), and what the
        # warps' aggregation leaves at ray order
        naive = n * L * 8
        groups = sum(B.brick_atomic_groups(x3, meta))
        plain_ms = _time_ms(lambda: B.brick_nablas_bwd_xla(
            g2, x3, table, gg, meta), iters=5)
        # each (point, level): 18 index/scale ops + 8 corners × (11 for c_k
        # + 4 for dL/dg_up + 4 for dL/dtable) = 170; dL/dx + 8 × 25
        io = n * (8 * L + 12 + 12 + 8 * L) + 2 * tab_bytes
        bound = _bound(io, n * L * 170)
        bound_dx = _bound(io + n * 12, n * L * 370)
        print(f"[B9 brick_bwd2] need_dx false (the step's form): kernel "
              f"{ms:.4f} ms (permuted {ms_perm:.4f} ms) | bound "
              f"{bound[0]:.4f} ms ({bound[1]}); need_dx true: kernel "
              f"{ms_dx:.4f} ms | bound {bound_dx[0]:.4f} ms "
              f"({bound_dx[1]}); plain (all three gradients) {plain_ms:.4f}"
              f" ms | library: none | float2 atomics {groups:,} of "
              f"{naive:,} after the warps' aggregation")
        _kernel_row(kernels, name="brick_bwd2 (B9)", key="brick_bwd2",
                    path="f2 train step", source=src, replaces=f"{rep}:1077",
                    err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                    ms_need_dx=ms_dx, bound_ms_need_dx=bound_dx[0],
                    ms_permuted=ms_perm, atomics_naive=naive,
                    atomic_groups=groups)
    return x3


def _forest_kernel_phases(forest, o, d, kernels) -> None:
    """The forest forms of B6 and B8 (`brick_fwd_b`, `brick_dydx_b`) on the
    inputs of each of their launches in one forest render (outside the
    counted renders), each held against its plain version
    (`brick_encode_xla_batched`, `brick_nablas_xla_batched`) and timed;
    the rows take the largest launch's numbers and list every launch's."""
    import torch
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    src = "nr3d_lib_tpu_torch/csrc/brick.cu"
    rep = "nr3d_lib_tpu/ops/lotd_brick.py"
    for fn, key, name, replaces, plain in (
            ("_fwd_cuda", "brick_fwd_b", "brick_fwd_b (B6, forest)",
             f"{rep}:440", B.brick_encode_xla_batched),
            ("_dydx_cuda", "brick_dydx_b", "brick_dydx_b (B8, forest)",
             f"{rep}:992", B.brick_nablas_xla_batched)):
        calls = _render_fwd_calls(forest, o, d, B, fn)
        _require(calls and all(kw.get("bidx") is not None
                               for _, kw in calls),
                 f"{key}: the forest render made no launch with bidx")
        launches = []
        with torch.no_grad():
            for k, (args, kw) in enumerate(calls):
                bidx = kw["bidx"]
                if fn == "_fwd_cuda":
                    x, table, meta = args[:3]

                    def plain_call():
                        return plain(x, table, meta, bidx)
                    got = B._fwd_cuda(x, table, meta, bidx=bidx)
                    want = plain_call()
                    tol = 1e-5 + 1e-5 * float(want.abs().max())
                    why = "8-term sums in another order"
                    # B6's bytes and operations, and 4 B of bidx a point
                    io = x.shape[0] * (12 + 4 + 8 * meta.n_levels)
                    ops = x.shape[0] * meta.n_levels * 60
                else:
                    g, x, table, meta = args[:4]

                    def plain_call():
                        return plain(g, x, table, meta, bidx)
                    got = B._dydx_cuda(g, x, table, meta, bidx=bidx)
                    want = plain_call()
                    tol = 1e-4 + 1e-4 * float(want.abs().max())
                    why = "sums over corners, features and levels, " \
                        "scaled by res-2, in another order"
                    # B8's bytes and operations, and 4 B of bidx a point
                    io = x.shape[0] * (12 + 4 + 8 * meta.n_levels + 12)
                    ops = x.shape[0] * meta.n_levels * 111
                bound = _bound(io + table.numel() * 4, ops)
                n, L = x.shape[0], meta.n_levels
                blocks = table.shape[0] // meta.total_rows
                err = _check(f"{name} launch {k}, {blocks} blocks of "
                             f"{meta.total_rows} rows", n,
                             [("out", _err(got, want), tol, why)])
                ms = _time_ms(lambda: getattr(B, fn)(*args, **kw))
                plain_ms = _time_ms(plain_call, iters=3)
                print(f"[{name} launch {k}] {n:,} points x {L} levels, bidx "
                      f"< 0 at {int((bidx < 0).sum()):,}: kernel {ms:.4f} ms"
                      f" | plain {plain_ms:.4f} ms | bound {bound[0]:.4f} ms "
                      f"({bound[1]}) | library: none")
                launches.append(dict(n=n, err=err, ms=ms, plain_ms=plain_ms,
                                     bound=bound, levels=L, blocks=blocks))
        top = max(launches, key=lambda r: r["n"])
        _kernel_row(kernels, name=name, key=key, path="forest_serve_8192",
                    source=src, replaces=replaces,
                    err=max(r["err"] for r in launches), ms=top["ms"],
                    plain_ms=top["plain_ms"], bound=top["bound"],
                    n_points=top["n"], levels=top["levels"],
                    blocks=top["blocks"],
                    n_points_by_launch_render=[r["n"] for r in launches],
                    ms_by_launch_render=[r["ms"] for r in launches],
                    plain_ms_by_launch_render=[r["plain_ms"]
                                               for r in launches],
                    bound_ms_by_launch_render=[r["bound"][0]
                                               for r in launches])


def _forest_train_kernel_phases(model, o, d, kernels) -> None:
    """The forest forms of B7 and B9 (`brick_bwd_b`, `brick_bwd2_b`) on the
    inputs that one forest train step (it = 1, no optimizer step) hands
    each launch: held against their plain versions
    (`brick_encode_bwd_xla_batched`, `brick_nablas_bwd_xla_batched`) in
    the step's form (no dL/dx: x comes from the no-grad march) and with
    dL/dx; timed in ray order and on the same points permuted, where
    dL/dx and B9's dL/dg_up must be the same bits; their atomics counted
    before and after the warps' aggregation (on the global slot)."""
    import torch
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    src = "nr3d_lib_tpu_torch/csrc/brick.cu"
    rep = "nr3d_lib_tpu/ops/lotd_brick.py"
    rec = _record_step(model, o, d, 1, B, ("_bwd_cuda", "_bwd2_cuda"),
                       loss_fn=_forest_loss)
    dev = o.device
    with torch.no_grad():
        # ------------------------------------------------ B7 forest
        a = rec["_bwd_cuda"]
        x, g, meta, table, bidx = (a["x"], a["g"], a["meta"], a["table"],
                                   a["bidx"])
        _require(bidx is not None and not a["need_dx"] and
                 a["corners"] is None, "brick_bwd_b: the step's B7 is not "
                 "the forest form without dL/dx")
        n, L = x.shape[0], meta.n_levels
        blocks = table.shape[0] // meta.total_rows
        tab_bytes = table.numel() * 4
        dx_p, dtab_p = B.brick_encode_bwd_xla_batched(x, table, g, meta,
                                                      bidx, True)
        _, dtab_k = B._bwd_cuda(x, g, meta, need_dx=False, table=table,
                                bidx=bidx)
        dx_k, dtab_k2 = B._bwd_cuda(x, g, meta, need_dx=True, table=table,
                                    bidx=bidx)
        err = _check(f"brick_bwd_b (B7, forest), {blocks} blocks of "
                     f"{meta.total_rows} rows", n, [
                         ("dL/dtable", max(_err(dtab_k, dtab_p),
                                           _err(dtab_k2, dtab_p)),
                          1e-6 + 1e-5 * float(dtab_p.abs().max()),
                          "sums by atomics in an order that changes from "
                          "run to run"),
                         ("dL/dx", _err(dx_k, dx_p),
                          1e-4 + 1e-4 * float(dx_p.abs().max()),
                          "sums over corners, features and levels scaled "
                          "by res-2")])
        perm = torch.randperm(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(19))
        xp, gp, bp = (v[perm].contiguous() for v in (x, g, bidx))
        dx_perm, _ = B._bwd_cuda(xp, gp, meta, need_dx=True, table=table,
                                 bidx=bp)
        _require(torch.equal(dx_perm, dx_k[perm]), "brick_bwd_b: a point's "
                 "dL/dx depends on its place in the batch")
        ms = _time_ms(lambda: B._bwd_cuda(x, g, meta, need_dx=False,
                                          table=table, bidx=bidx))
        ms_perm = _time_ms(lambda: B._bwd_cuda(xp, gp, meta, need_dx=False,
                                               table=table, bidx=bp))
        ms_dx = _time_ms(lambda: B._bwd_cuda(x, g, meta, need_dx=True,
                                             table=table, bidx=bidx))
        plain_ms = _time_ms(lambda: B.brick_encode_bwd_xla_batched(
            x, table, g, meta, bidx, False), iters=5)
        plain_dx = _time_ms(lambda: B.brick_encode_bwd_xla_batched(
            x, table, g, meta, bidx, True), iters=5)
        naive = n * L * 8
        groups = sum(B.brick_atomic_groups(x, meta, bidx))
        groups_perm = sum(B.brick_atomic_groups(xp, meta, bp))
        # x, bidx and g in, the zeroed dL/dtable out; with dL/dx also the
        # table in and dx out. Operations as B7's: 44 a (point, level),
        # 140 with dL/dx
        bound = _bound(n * (12 + 4 + 8 * L) + tab_bytes, n * L * 44)
        bound_dx = _bound(n * (12 + 4 + 8 * L + 12) + 2 * tab_bytes,
                          n * L * 140)
        print(f"[brick_bwd_b (B7, forest)] {n:,} points x {L} levels, "
              f"bidx < 0 at {int((bidx < 0).sum()):,}; need_dx false (the "
              f"step's form): kernel {ms:.4f} ms (permuted {ms_perm:.4f} ms)"
              f" | plain {plain_ms:.4f} ms | bound {bound[0]:.4f} ms "
              f"({bound[1]}); need_dx true: kernel {ms_dx:.4f} ms | plain "
              f"{plain_dx:.4f} ms | bound {bound_dx[0]:.4f} ms "
              f"({bound_dx[1]}) | library: none | float2 atomics {groups:,}"
              f" of {naive:,} after the warps' aggregation ({groups_perm:,}"
              f" permuted)")
        _kernel_row(kernels, name="brick_bwd_b (B7, forest)",
                    key="brick_bwd_b", path="forest_train_4096", source=src,
                    replaces=f"{rep}:636", err=err, ms=ms, plain_ms=plain_ms,
                    bound=bound, n_points=n, levels=L, blocks=blocks,
                    ms_need_dx=ms_dx, plain_ms_need_dx=plain_dx,
                    bound_ms_need_dx=bound_dx[0], ms_permuted=ms_perm,
                    atomics_naive=naive, atomic_groups=groups,
                    atomic_groups_permuted=groups_perm)

        # ------------------------------------------------ B9 forest
        a = rec["_bwd2_cuda"]
        g_up, x, table, gg, meta, bidx = (a["g_up"], a["x"], a["table"],
                                          a["gg"], a["meta"], a["bidx"])
        _require(bidx is not None and not a["need_dx"], "brick_bwd2_b: the "
                 "step's B9 is not the forest form without dL/dx")
        n, L = x.shape[0], meta.n_levels
        dg_p, dx_p, dt_p = B.brick_nablas_bwd_xla_batched(g_up, x, table, gg,
                                                          meta, bidx)
        dg_k, none_dx, dt_k = B._bwd2_cuda(g_up, x, table, gg, meta,
                                           need_dx=False, bidx=bidx)
        dg_k2, dx_k, dt_k2 = B._bwd2_cuda(g_up, x, table, gg, meta,
                                          bidx=bidx)
        _require(none_dx is None and torch.equal(dg_k, dg_k2),
                 "brick_bwd2_b: need_dx changed dL/dg_up or wrote dL/dx")
        err = _check(f"brick_bwd2_b (B9, forest), {blocks} blocks", n, [
            ("dL/dg_up", _err(dg_k, dg_p),
             1e-4 + 1e-4 * float(dg_p.abs().max()),
             "sums over corners scaled by res-2 in another order"),
            ("dL/dx", _err(dx_k, dx_p), 1e-4 + 1e-4 * float(dx_p.abs().max()),
             "sums over corners scaled by (res-2)^2 in another order"),
            ("dL/dtable", max(_err(dt_k, dt_p), _err(dt_k2, dt_p)),
             1e-6 + 1e-5 * float(dt_p.abs().max()),
             "atomics, order changes from run to run")])
        perm = torch.randperm(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(20))
        xp, gp, ggp, bp = (v[perm].contiguous()
                           for v in (x, g_up, gg, bidx))
        dg_perm, dx_perm, _ = B._bwd2_cuda(gp, xp, table, ggp, meta, bidx=bp)
        _require(torch.equal(dg_perm, dg_k[perm]) and
                 torch.equal(dx_perm, dx_k[perm]),
                 "brick_bwd2_b: a point's dL/dg_up or dL/dx depends on its "
                 "place in the batch")
        ms = _time_ms(lambda: B._bwd2_cuda(g_up, x, table, gg, meta,
                                           need_dx=False, bidx=bidx))
        ms_perm = _time_ms(lambda: B._bwd2_cuda(gp, xp, table, ggp, meta,
                                                need_dx=False, bidx=bp))
        ms_dx = _time_ms(lambda: B._bwd2_cuda(g_up, x, table, gg, meta,
                                              bidx=bidx))
        plain_ms = _time_ms(lambda: B.brick_nablas_bwd_xla_batched(
            g_up, x, table, gg, meta, bidx), iters=5)
        naive = n * L * 8
        groups = sum(B.brick_atomic_groups(x, meta, bidx))
        groups_perm = sum(B.brick_atomic_groups(xp, meta, bp))
        # g_up, x, bidx, gg in, dL/dg_up out, the table in and the zeroed
        # dL/dtable out; operations as B9's: 170, 370 with dL/dx
        io = n * (8 * L + 12 + 4 + 12 + 8 * L) + 2 * tab_bytes
        bound = _bound(io, n * L * 170)
        bound_dx = _bound(io + n * 12, n * L * 370)
        print(f"[brick_bwd2_b (B9, forest)] {n:,} points x {L} levels; "
              f"need_dx false (the step's form): kernel {ms:.4f} ms "
              f"(permuted {ms_perm:.4f} ms) | bound {bound[0]:.4f} ms "
              f"({bound[1]}); need_dx true: kernel {ms_dx:.4f} ms | bound "
              f"{bound_dx[0]:.4f} ms ({bound_dx[1]}); plain (all three "
              f"gradients) {plain_ms:.4f} ms | library: none | float2 "
              f"atomics {groups:,} of {naive:,} after the warps' "
              f"aggregation ({groups_perm:,} permuted)")
        _kernel_row(kernels, name="brick_bwd2_b (B9, forest)",
                    key="brick_bwd2_b", path="forest_train_4096", source=src,
                    replaces=f"{rep}:1077", err=err, ms=ms,
                    plain_ms=plain_ms, bound=bound, n_points=n, levels=L,
                    blocks=blocks, ms_need_dx=ms_dx,
                    bound_ms_need_dx=bound_dx[0], ms_permuted=ms_perm,
                    atomics_naive=naive, atomic_groups=groups,
                    atomic_groups_permuted=groups_perm)


def _permuto4_kernel_phases(model, o, d, ts, kernels) -> None:
    """Path C: B14, B15 (with and without dL/dx) and B16 at the dynamic
    NeuS's final query: 4096 rays × 96 samples = 393,216 (x,t) points, 4
    levels, a packed table of 14,080 rows."""
    import torch
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC
    from nr3d_lib_tpu_torch.ops import permuto_cell4 as P4

    src = "nr3d_lib_tpu_torch/csrc/permuto_cell4.cu"
    rep = "nr3d_lib_tpu/ops/permuto_cell4.py"
    dev = o.device
    bank = model.field.implicit_surface.bank
    meta = bank.meta
    with torch.no_grad():
        table = bank.flattened_params.detach()
        packed = P4.pack_table4(table)
        table_bytes = packed.numel() * 4               # 7.2 MB packed
        dtab_bytes = table.numel() * 4                 # the zeroed f32 output
        x = _dyn_points(o, d, ts, 96, seed=16)
        n, L, dim = x.shape[0], meta.n_levels, meta.n_dims
        gen = torch.Generator(device=dev).manual_seed(17)
        g = torch.randn(n, 4 * L, device=dev, generator=gen)
        # each (point, level): the simplex search (`_simplex_ops`, 240 at
        # d = 4), then the blend 5 vertices × (4 unpacks + 4 FMAs) = 40
        simplex_ops = _simplex_ops(dim)

        # ------------------------------------------------ B14 permuto4_fwd
        y_p = P4.permuto_cell4_encode_xla(x, table, meta)
        err = _check(f"B14 permuto4_fwd, L={L}", n, [(
            "y", _err(P4.permuto_cell4_encode(x, table, meta), y_p),
            1e-5 + 1e-5 * float(y_p.abs().max()),
            "5 weighted vertices summed in another order")])
        ms = _time_ms(lambda: P4._fwd_cuda(x, packed, meta))
        # the path feeds points ray by ray; the same points in a random
        # order show what the kernel owes to that order
        perm = torch.randperm(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(18))
        x_perm, g_perm = x[perm].contiguous(), g[perm].contiguous()
        _require(torch.equal(P4._fwd_cuda(x_perm, packed, meta),
                             P4._fwd_cuda(x, packed, meta)[perm]),
                 "B14: a point's encoding depends on its place in the batch")
        ms_perm = _time_ms(lambda: P4._fwd_cuda(x_perm, packed, meta))
        plain_ms = _time_ms(lambda: P4.permuto_cell4_encode_xla(x, table,
                                                                meta), iters=5)
        bound = _bound(n * (4 * dim + 16 * L) + table_bytes,
                       n * L * (simplex_ops + 40))
        print(f"[B14 permuto4_fwd] kernel {ms:.4f} ms (the same points "
              f"permuted: {ms_perm:.4f} ms, bitwise the same rows) | plain "
              f"{plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]}) | "
              f"library: none")
        _kernel_row(kernels, name="permuto4_fwd (B14)", key="permuto4_fwd",
                    path="dyn render", source=src, replaces=f"{rep}:142",
                    err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                    ms_permuted=ms_perm)

        # ----------------- B15 permuto4_bwd: dL/dtable by float4 atomics
        dx_p, dtab_p = P4.permuto_cell4_encode_bwd_xla(x, table, g, meta, True)
        _, dtab_k = P4._bwd_cuda(x, g, meta, need_dx=False)
        dx_k, dtab_k2 = P4._bwd_cuda(x, g, meta, need_dx=True, packed=packed)
        err = _check("B15 permuto4_bwd", n, [
            ("dL/dtable", max(_err(dtab_k, dtab_p), _err(dtab_k2, dtab_p)),
             1e-6 + 1e-5 * float(dtab_p.abs().max()),
             "thousands of terms per dense slot summed by atomics in an "
             "order that changes from run to run"),
            ("dL/dx", _err(dx_k, dx_p), 1e-4 + 1e-4 * float(dx_p.abs().max()),
             "sums through the elevation Jacobian, scaled by the lattice "
             "scale")])
        # dL/dx sums each point's levels in one block: the same bits in
        # any order of the points
        dx_perm, _ = P4._bwd_cuda(x_perm, g_perm, meta, need_dx=True,
                                  packed=packed)
        _require(torch.equal(dx_perm, dx_k[perm]),
                 "B15: a point's dL/dx depends on its place in the batch")
        ms = _time_ms(lambda: P4._bwd_cuda(x, g, meta, need_dx=False))
        ms_dx = _time_ms(lambda: P4._bwd_cuda(x, g, meta, need_dx=True,
                                              packed=packed))
        ms_perm = _time_ms(lambda: P4._bwd_cuda(x_perm, g_perm, meta,
                                                need_dx=False))
        # float4 atomics: one a (point, level, vertex), and what the warps'
        # aggregation leaves at this order (a warp = 32 consecutive points
        # at one level)
        naive = n * L * (dim + 1)
        groups = sum(PC.atomic_groups(x, meta))
        plain_ms = _time_ms(lambda: P4.permuto_cell4_encode_bwd_xla(
            x, table, g, meta, False), iters=5)
        plain_dx = _time_ms(lambda: P4.permuto_cell4_encode_bwd_xla(
            x, table, g, meta, True), iters=5)
        # the simplex search + 5 vertices × 4 products (the atomics' adds
        # are the L2's); with dL/dx + 5 × (4 unpacks + 7 for g·val) + the
        # elevation vjp (~30)
        bound = _bound(n * (4 * dim + 16 * L) + dtab_bytes,
                       n * L * (simplex_ops + 20))
        bound_dx = _bound(n * (4 * dim + 16 * L + 4 * dim) + table_bytes +
                          dtab_bytes, n * L * (simplex_ops + 20 + 55 + 30))
        print(f"[B15 permuto4_bwd] need_dx false (the step's form): kernel "
              f"{ms:.4f} ms (permuted {ms_perm:.4f} ms) | plain "
              f"{plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]}); "
              f"need_dx true: kernel {ms_dx:.4f} ms | plain {plain_dx:.4f} "
              f"ms | bound {bound_dx[0]:.4f} ms ({bound_dx[1]}) | library: "
              f"none | float4 atomics {groups:,} of {naive:,} after the "
              f"warps' aggregation")
        _kernel_row(kernels, name="permuto4_bwd (B15)", key="permuto4_bwd",
                    path="dyn train step", source=src, replaces=f"{rep}:222",
                    err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                    ms_need_dx=ms_dx, plain_ms_need_dx=plain_dx,
                    bound_ms_need_dx=bound_dx[0], ms_permuted=ms_perm,
                    atomics_naive=naive, atomic_groups=groups)

        # ----------------------------------------------- B16 permuto4_dydx
        n_p = P4.permuto_cell4_nablas_xla(g, x, table, meta)
        err = _check("B16 permuto4_dydx", n, [(
            "nablas", _err(P4.permuto_cell4_nablas(g, x, table, meta), n_p),
            1e-4 + 1e-4 * float(n_p.abs().max()),
            f"sums over 5 vertices × 4 feats × {L} levels through the "
            f"elevation Jacobian, in another order")])
        # B16 sums each point's levels in its block: the same bits in
        # another order of the points
        _require(torch.equal(P4._dydx_cuda(g_perm, x_perm, packed, meta),
                             P4._dydx_cuda(g, x, packed, meta)[perm]),
                 "B16: a point's nablas depend on its place in the batch")
        ms = _time_ms(lambda: P4._dydx_cuda(g, x, packed, meta))
        ms_perm = _time_ms(lambda: P4._dydx_cuda(g_perm, x_perm, packed,
                                                 meta))
        plain_ms = _time_ms(lambda: P4.permuto_cell4_nablas_xla(g, x, table,
                                                                meta), iters=5)
        bound = _b16_bound(n, dim, L, table_bytes)
        # its backward on the CUDA path is plain PyTorch (the JAX package's
        # is XLA): the vjp of the plain nablas, gathers and index_add_
        gg = torch.randn(n, dim, device=dev, generator=gen)
        bwd_ms = _time_ms(lambda: P4.permuto_cell4_nablas_bwd_xla(
            g, x, table, gg, meta), iters=5)
        print(f"[B16 permuto4_dydx] kernel {ms:.4f} ms (the same points "
              f"permuted: {ms_perm:.4f} ms, bitwise the same nablas) | plain "
              f"{plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]}) | "
              f"library: none | its backward (plain PyTorch, no kernel) "
              f"{bwd_ms:.4f} ms")
        _kernel_row(kernels, name="permuto4_dydx (B16)", key="permuto4_dydx",
                    path="dyn render", source=src, replaces=f"{rep}:544",
                    err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                    ms_permuted=ms_perm, backward_plain_ms=bwd_ms)
        # its ~700 small kernels fill the launch queue, so the events above
        # may time the host; the profile gives the device's own time
        _profile(lambda: P4.permuto_cell4_nablas_bwd_xla(g, x, table, gg,
                                                         meta),
                 bwd_ms, "plain nablas backward at 393,216 points")


def _simplex_ops(d: int) -> int:
    """Float and integer operations of one (point, level)'s simplex search
    in `csrc/permuto_simplex.cuh`: elevation 4d+3, rounding 9(d+1), rank
    3(d+1)², sum fix-up 4(d+1), weights 4(d+1)−1, vertex slots 2(d+1)²,
    hash or box index 3d (240 at d = 4, 171 at d = 3)."""
    dp1 = d + 1
    return (4 * d + 3) + 9 * dp1 + 3 * dp1 ** 2 + 4 * dp1 + \
        (4 * dp1 - 1) + 2 * dp1 ** 2 + 3 * d


def _permuto_kernel_phases(pathd, field, o, d, ts, kernels) -> None:
    """Path D and the field phase: B10, B11, B12 and B13 at two shapes —
    path D's final query (4096 rays × 96 samples = 393,216 (x,t) points,
    5 hashed levels, 20,480 rows) and the 3D bench lattice (393,216
    points along the rays, 8 levels with a dense level 0, 30,657 rows).
    One row per kernel; the path D shape's numbers are the row's own, the
    3D lattice's carry the suffix `_3d`."""
    import torch
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    src = "nr3d_lib_tpu_torch/csrc/permuto_cell.cu"
    rep = "nr3d_lib_tpu/ops/permuto_cell.py"
    dev = o.device
    rows = {k: {} for k in ("fwd", "bwd", "dydx")}
    errs = {k: [] for k in rows}
    shapes = (("path D", "", pathd.field.implicit_surface.bank,
               _dyn_points(o, d, ts, 96, seed=26)),
              ("3D lattice", "_3d", field.bank,
               _ray_points(o, d, 96, seed=27)))
    with torch.no_grad():
        for what, sfx, bank, x in shapes:
            meta = bank.meta
            table = bank.flattened_params.detach()
            n, L, dim = x.shape[0], meta.n_levels, meta.n_dims
            table_bytes = table.numel() * 4        # read, or the zeroed dtab
            gen = torch.Generator(device=dev).manual_seed(28)
            g = torch.randn(n, 2 * L, device=dev, generator=gen)
            sops = _simplex_ops(dim)
            label = f"{what}, N={n}, d={dim}, L={L}, {meta.total_rows} rows"

            # ------------------------------------------- B10 permuto_fwd
            y_p = PC.permuto_cell_encode_xla(x, table, meta)
            err = _check(f"B10 permuto_fwd, {label}", n, [(
                "y", _err(PC.permuto_cell_encode(x, table, meta), y_p),
                1e-5 + 1e-5 * float(y_p.abs().max()),
                f"{dim + 1} weighted vertices summed in another order")])
            ms = _time_ms(lambda: PC._fwd_cuda(x, table, meta))
            # the paths feed points ray by ray; the same points in a random
            # order show what the kernel owes to that order
            perm = torch.randperm(n, device=dev, generator=torch.Generator(
                device=dev).manual_seed(29))
            x_perm = x[perm].contiguous()
            _require(torch.equal(PC._fwd_cuda(x_perm, table, meta),
                                 PC._fwd_cuda(x, table, meta)[perm]),
                     f"B10 at {what}: a point's encoding depends on its "
                     f"place in the batch")
            ms_perm = _time_ms(lambda: PC._fwd_cuda(x_perm, table, meta))
            plain_ms = _time_ms(lambda: PC.permuto_cell_encode_xla(
                x, table, meta), iters=5)
            # the simplex search + d+1 vertices × 2 features × (mul + add)
            bound = _bound(n * (4 * dim + 8 * L) + table_bytes,
                           n * L * (sops + 4 * (dim + 1)))
            print(f"[B10 permuto_fwd, {what}] kernel {ms:.4f} ms (the same "
                  f"points permuted: {ms_perm:.4f} ms, bitwise the same "
                  f"rows) | plain {plain_ms:.4f} ms | bound {bound[0]:.4f} "
                  f"ms ({bound[1]}) | library: none")
            errs["fwd"].append(err)
            rows["fwd"].update({f"ms{sfx}": ms, f"plain_ms{sfx}": plain_ms,
                                f"bound{sfx}": bound,
                                f"ms_permuted{sfx}": ms_perm})

            # ------- B11 / B12 permuto_bwd: dL/dtable by float2 atomics
            dx_p, dtab_p = PC.permuto_cell_encode_bwd_xla(x, table, g, meta,
                                                          True)
            _, dtab_k = PC._bwd_cuda(x, g, meta, need_dx=False)
            dx_k, dtab_k2 = PC._bwd_cuda(x, g, meta, need_dx=True,
                                         table=table)
            err = _check(f"B11/B12 permuto_bwd, {label}", n, [
                ("dL/dtable", max(_err(dtab_k, dtab_p),
                                  _err(dtab_k2, dtab_p)),
                 1e-6 + 1e-5 * float(dtab_p.abs().max()),
                 "up to thousands of terms per slot summed by atomics in "
                 "an order that changes from run to run"),
                ("dL/dx", _err(dx_k, dx_p),
                 1e-4 + 1e-4 * float(dx_p.abs().max()),
                 "sums through the elevation Jacobian, scaled by the "
                 "lattice scale")])
            # B12's dL/dx sums each point's levels in its block: the same
            # bits in another order of the points
            g_perm = g[perm].contiguous()
            dx_perm, _ = PC._bwd_cuda(x_perm, g_perm, meta, need_dx=True,
                                      table=table)
            _require(torch.equal(dx_perm, dx_k[perm]),
                     f"B12 at {what}: a point's dL/dx depends on its place "
                     f"in the batch")
            ms = _time_ms(lambda: PC._bwd_cuda(x, g, meta, need_dx=False))
            ms_dx = _time_ms(lambda: PC._bwd_cuda(x, g, meta, need_dx=True,
                                                  table=table))
            ms_perm = _time_ms(lambda: PC._bwd_cuda(x_perm, g_perm, meta,
                                                    need_dx=False))
            # float2 atomics: one a (point, level, vertex), and what the
            # warps' aggregation leaves at ray order
            naive = n * L * (dim + 1)
            groups = sum(PC.atomic_groups(x, meta))
            plain_ms = _time_ms(lambda: PC.permuto_cell_encode_bwd_xla(
                x, table, g, meta, False), iters=5)
            plain_dx = _time_ms(lambda: PC.permuto_cell_encode_bwd_xla(
                x, table, g, meta, True), iters=5)
            # the simplex search + d+1 vertices × 2 products (the atomics'
            # adds are the L2's); with dL/dx + (d+1) × 3 for g·val + the
            # elevation vjp ~6(d+1)
            bound = _bound(n * (4 * dim + 8 * L) + table_bytes,
                           n * L * (sops + 2 * (dim + 1)))
            bound_dx = _bound(n * (4 * dim + 8 * L + 4 * dim) +
                              2 * table_bytes,
                              n * L * (sops + 11 * (dim + 1)))
            print(f"[B11/B12 permuto_bwd, {what}] need_dx false (B11, the "
                  f"step's form): kernel {ms:.4f} ms (permuted {ms_perm:.4f}"
                  f" ms) | plain {plain_ms:.4f} ms | bound {bound[0]:.4f} ms"
                  f" ({bound[1]}); need_dx true (B12): kernel {ms_dx:.4f} "
                  f"ms | plain {plain_dx:.4f} ms | bound {bound_dx[0]:.4f} "
                  f"ms ({bound_dx[1]}) | library: none | float2 atomics "
                  f"{groups:,} of {naive:,} after the warps' aggregation")
            errs["bwd"].append(err)
            rows["bwd"].update({
                f"ms{sfx}": ms, f"plain_ms{sfx}": plain_ms,
                f"bound{sfx}": bound, f"ms_need_dx{sfx}": ms_dx,
                f"plain_ms_need_dx{sfx}": plain_dx,
                f"bound_ms_need_dx{sfx}": bound_dx[0],
                f"ms_permuted{sfx}": ms_perm,
                f"atomics_naive{sfx}": naive, f"atomic_groups{sfx}": groups})

            # ------------------------------------------ B13 permuto_dydx
            n_p = PC.permuto_cell_nablas_xla(g, x, table, meta)
            err = _check(f"B13 permuto_dydx, {label}", n, [(
                "nablas", _err(PC.permuto_cell_nablas(g, x, table, meta),
                               n_p),
                1e-4 + 1e-4 * float(n_p.abs().max()),
                f"sums over {dim + 1} vertices × 2 feats × {L} levels "
                f"through the elevation Jacobian, in another order")])
            # B13 sums each point's levels in its block: the same bits in
            # another order of the points
            _require(torch.equal(PC._dydx_cuda(g_perm, x_perm, table, meta),
                                 PC._dydx_cuda(g, x, table, meta)[perm]),
                     f"B13 at {what}: a point's nablas depend on its place "
                     f"in the batch")
            ms = _time_ms(lambda: PC._dydx_cuda(g, x, table, meta))
            ms_perm = _time_ms(lambda: PC._dydx_cuda(g_perm, x_perm, table,
                                                     meta))
            plain_ms = _time_ms(lambda: PC.permuto_cell_nablas_xla(
                g, x, table, meta), iters=5)
            bound = _b13_bound(n, dim, L, table_bytes)
            # its backward on the CUDA path is plain PyTorch (the JAX
            # package's is XLA): the vjp of the plain nablas
            gg = torch.randn(n, dim, device=dev, generator=gen)
            bwd_ms = _time_ms(lambda: PC.permuto_cell_nablas_bwd_xla(
                g, x, table, gg, meta), iters=5)
            print(f"[B13 permuto_dydx, {what}] kernel {ms:.4f} ms (the "
                  f"same points permuted: {ms_perm:.4f} ms, bitwise the same "
                  f"nablas) | plain {plain_ms:.4f} ms | bound "
                  f"{bound[0]:.4f} ms ({bound[1]}) | library: none | its "
                  f"backward (plain PyTorch, no kernel) {bwd_ms:.4f} ms")
            errs["dydx"].append(err)
            rows["dydx"].update({f"ms{sfx}": ms, f"plain_ms{sfx}": plain_ms,
                                 f"bound{sfx}": bound,
                                 f"ms_permuted{sfx}": ms_perm,
                                 f"backward_plain_ms{sfx}": bwd_ms})
            if not sfx:
                # many small kernels fill the launch queue, so the events
                # above may time the host; the profile gives the device's
                _profile(lambda: PC.permuto_cell_nablas_bwd_xla(
                    g, x, table, gg, meta), bwd_ms,
                    f"plain F=2 nablas backward at {what}'s {n:,} points")
    for key, name, path, line, extra in (
            ("fwd", "permuto_fwd (B10)", "pathd render", 393, {}),
            ("bwd", "permuto_bwd (B11, B12)", "pathd train step", 533,
             {"replaces_need_dx": f"{rep}:698",
              "path_need_dx": "field autograd nablas"}),
            ("dydx", "permuto_dydx (B13)", "pathd render", 1175, {})):
        r = rows[key]
        b3 = r.pop("bound_3d")
        extra.update({k: v for k, v in r.items()
                      if k not in ("ms", "plain_ms", "bound")})
        _kernel_row(kernels, name=name, key=f"permuto_{key}", path=path,
                    source=src, replaces=f"{rep}:{line}",
                    err=max(errs[key]), ms=r["ms"], plain_ms=r["plain_ms"],
                    bound=r["bound"], bound_ms_3d=b3[0], **extra)


def _field_phase(sdf, nerf, sdf_cpu, nerf_cpu, o, d, paths, smi) -> None:
    """The static 3D permuto fields through their entry points on 393,216
    points along the rays, each path with exact launches, each held
    against the CPU port on the same points and weights."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build

    x = _ray_points(o, d, 96, seed=29) * 2.0 - 1.0      # the fields' [-1,1]
    xc = x.cpu()
    n = x.shape[0]
    print(f"[field] PermutoSDF / PermutoNeRF, F=2 cell, "
          f"{sdf.bank.meta.total_rows} table rows, {n} points, on {smi}")

    # ---------------------------------- the split nablas: B10 + B13
    with torch.no_grad():
        _build.LAUNCHES.clear()
        out = sdf.forward_sdf_nablas(x)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        ms = _time_ms(lambda: sdf.forward_sdf_nablas(x), iters=10)
        ref = sdf_cpu.forward_sdf_nablas(xc)
    parts = []
    for k in ("sdf", "h", "nablas"):
        _require(bool(torch.isfinite(out[k]).all()), f"field {k} not finite")
        parts.append((k, _err(out[k].cpu(), ref[k]),
                      1e-5 + 1e-4 * float(ref[k].abs().max()),
                      "the decoder's matmuls and the lattice sums in "
                      "another order"))
    _check("field sdf nablas vs cpu", n, parts)
    print(f"[field sdf nablas] forward_sdf_nablas {ms:.4f} ms per call of "
          f"{n} points; launches {launches}")
    _require(launches == {"permuto_fwd": 1, "permuto_dydx": 1},
             "the split nablas did not run B10 and B13 once")
    paths["field sdf nablas"] = (launches, 1)

    # --------------------- the autograd nablas: B10 + B12 (x needs grad)
    _build.LAUNCHES.clear()
    xr = x.clone().requires_grad_(True)
    (nab, ) = torch.autograd.grad(sdf.forward_sdf(xr)["sdf"].sum(), xr)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    err = _err(nab, out["nablas"])
    tol = 1e-5 + 1e-4 * float(out["nablas"].abs().max())
    print(f"[field autograd nablas] {n} points: launches {launches}; "
          f"max|autograd - split| {err:.3e} (tolerance {tol:.3e}: B12's "
          f"dL/dx and B13 sum the same terms in another order)")
    _require(launches == {"permuto_fwd": 1, "permuto_bwd": 1},
             "the autograd nablas did not run B10 and B12 once")
    _require(err <= tol, "autograd and split nablas disagree")
    paths["field autograd nablas"] = (launches, 1)

    # ------------------- the NeRF density forward + backward: B10 + B11
    def nerf_loss(m, xx):
        out = m.forward_density(xx)
        return torch.mean(out["sigma"]) + torch.mean(out["h"] ** 2)

    nerf.zero_grad(set_to_none=True)
    _build.LAUNCHES.clear()
    nerf_loss(nerf, x).backward()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    nerf_cpu.zero_grad(set_to_none=True)
    nerf_loss(nerf_cpu, xc).backward()
    # the density's parameters: the table and the decoder (the radiance
    # head gets no gradient)
    pairs = [(k, p.grad, q.grad) for (k, p), q in zip(
        nerf.named_parameters(), nerf_cpu.parameters())]
    _require(all((a is None) == (b is None) for _, a, b in pairs),
             "card and CPU NeRF gradients cover other parameters")
    errs = {k: float(torch.linalg.norm(a.cpu() - b) /
                     max(float(torch.linalg.norm(b)), 1e-12))
            for k, a, b in pairs if b is not None}
    _require("bank.flattened_params" in errs, "the table got no gradient")
    print(f"[field nerf step] {n} points: launches {launches}; gradients "
          f"vs the CPU port, relative L2 per tensor (tolerance 1e-3: the "
          f"table's atomics over the dense level sum thousands of terms in "
          f"another order): " + ", ".join(f"{k} {e:.2e}"
                                         for k, e in errs.items()))
    _require(launches == {"permuto_fwd": 1, "permuto_bwd": 1},
             "the NeRF step did not run B10 and B11 once")
    _require(max(errs.values()) <= 1e-3, "NeRF gradients disagree")
    paths["field nerf step"] = (launches, 1)


def _pretrained(cls, cfg, dev, label: str):
    """The example's model: `pretrain_sdf_sphere(radius 0.5, 300
    iterations)` from its own init (seeded draws), then populate."""
    import torch
    from nr3d_lib_tpu_torch.models.fields.sdf import pretrain_sdf_sphere

    m = cls(**cfg, seed=0)
    t0 = time.perf_counter()
    loss = pretrain_sdf_sphere(m.field.implicit_surface,
                               torch.Generator(dev).manual_seed(0),
                               radius=0.5, n_iters=300)
    m.populate()
    torch.cuda.synchronize()
    occ = float(m.accel.occ.occ().float().mean())
    print(f"[{label} pretrain] pretrain_sdf_sphere(radius 0.5, 300 "
          f"iterations of 2048 points): last loss {loss:.3e}, "
          f"{time.perf_counter() - t0:.1f} s with populate; occupied "
          f"share of the {tuple(m.accel.occ.occ().shape)} grid {occ:.4f}")
    _require(np.isfinite(loss) and loss < 1e-2, "the sphere pretrain did "
             "not fit")
    return m


def _object_paths(dev, smi: str, paths: dict) -> None:
    """examples/train_neus_object.py on the card: the F=4 model pretrained
    to a sphere, served in its default mode and in sphere_trace, and
    trained as the example trains it; the --brick (F=2) variant served."""
    import torch
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    o, d = (torch.from_numpy(a).to(dev) for a in _rays(N_RAYS_OBJ, seed=2))

    # ------------------------------ F=2 (--brick): the validation render
    f2 = _pretrained(LoTDNeuSModel, OBJ_F2_CFG, dev, "neus_obj_f2")
    launches, _ = _serve(f2, _cpu_twin(f2, LoTDNeuSModel, OBJ_F2_CFG), o, d,
                         {"brick_fwd": 4, "brick_dydx": 1, "gather1d": 1},
                         "neus_obj_f2_serve_2048", smi)
    paths["neus_obj_f2_serve_2048"] = (launches, N_RENDERS)
    del f2

    # ------------------------------ F=4 (--w4): render, trace, train
    w4 = _pretrained(LoTDNeuSModel, OBJ_W4_CFG, dev, "neus_obj_w4")
    cpu = _cpu_twin(w4, LoTDNeuSModel, OBJ_W4_CFG)
    launches, _ = _serve(w4, cpu, o, d, {"brick4_fwd": 4, "brick4_dydx": 1,
                                         "gather1d": 1},
                         "neus_obj_w4_serve_2048", smi)
    paths["neus_obj_w4_serve_2048"] = (launches, N_RENDERS)

    w4.ray_query_cfg = dict(TRACE_CFG["ray_query_cfg"])
    with torch.no_grad():
        _, vb = w4.ray_query(w4.ray_test(o, d))
    iters = int(vb["trace_iters"])
    hit = float(vb["hit"][vb["ray_mask"]].float().mean())
    print(f"[neus_sphere_trace_serve_2048] the trace ran {iters} of at most "
          f"64 iterations (a live-ray test every 8); hit share {hit:.4f} "
          f"of the {int(vb['ray_mask'].sum())} rays that meet the box")
    _require(hit > 0.5, "the sphere trace hits too few rays")
    launches, _ = _serve(w4, cpu, o, d, {"brick4_fwd": iters + 2,
                                         "brick4_dydx": 1, "gather1d": 1},
                         "neus_sphere_trace_serve_2048", smi)
    paths["neus_sphere_trace_serve_2048"] = (launches, N_RENDERS)

    w4.ray_query_cfg = dict(OBJ_W4_CFG["ray_query_cfg"])
    cpu.ray_query_cfg = dict(OBJ_W4_CFG["ray_query_cfg"])
    _step_vs_cpu(w4, cpu, o, d, _cpu_seconds(
        lambda oo, dd: _obj_loss(cpu, oo, dd), o, d),
        "neus_obj_w4_train_2048", loss=_obj_loss)
    paths["neus_obj_w4_train_2048"] = (_train(
        w4, o, d, smi, "neus_obj_w4_train_2048",
        {"brick4_fwd": 4, "brick4_dydx": 1, "gather1d": 1, "brick4_bwd": 1,
         "brick4_bwd2": 1}, {"brick4_fwd": 1}, loss_fn=_obj_loss,
        lr=OBJ_LR, gated=True, clip=OBJ_CLIP), N_STEPS)


def _street_rays(n: int, seed: int):
    """examples/train_forest_street.py `sample_rays` from numpy: cameras
    hovering over the street, looking down the corridor."""
    rng = np.random.default_rng(seed)
    eye_x = rng.uniform(-2.8, 2.8, n)
    o = np.stack([eye_x, rng.uniform(0.2, 0.45, n),
                  rng.uniform(-0.45, 0.45, n)], -1)
    tgt = np.stack([eye_x + rng.normal(size=n) * 1.5, np.full(n, -0.25),
                    rng.normal(size=n) * 0.3], -1)
    d = tgt - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


class _FixedQuery:
    """examples/train_nerf_synthetic.py's render, `nerf_ray_query_fixed`
    at N_SAMPLES_FIXED samples a ray, as a model's ray query."""

    def __init__(self, model):
        self.model = model

    def ray_test(self, o, d):
        return self.model.ray_test(o, d)

    def ray_query(self, ray_tested, draw=None, generator=None):
        from nr3d_lib_tpu_torch.graphics.nerf_ray_query import \
            nerf_ray_query_fixed

        return nerf_ray_query_fixed(self.model, self.model.space, ray_tested,
                                    n_samples=N_SAMPLES_FIXED, draw=draw)


def _cpu_rays(cpu_fn, o, d) -> int:
    """The rays of a classic render's CPU comparison: all of them, or the
    first half, quarter, ... that the CPU port renders within
    CPU_RENDER_BUDGET_S (estimated from 256 rays)."""
    cpu_s = _cpu_seconds(cpu_fn, o, d, n_try=256)
    n = o.shape[0]
    while n > 256 and cpu_s * n / o.shape[0] > CPU_RENDER_BUDGET_S:
        n //= 2
    return n


def _classic_lotd_paths(dev, smi: str, paths: dict) -> None:
    """The three example trainers at their default flags, on the classic
    LoTD (plain PyTorch): the object NeuS pretrained to a sphere, served
    in march_occ_multi_upsample (1 B5 a render, no brick kernel) and
    trained as the example trains it (1 B5 a step); the NeRF served and
    trained through nerf_ray_query_fixed; the street forest served and
    trained. Each against its CPU twin."""
    import torch
    from nr3d_lib_tpu_torch.models.fields_forest import LoTDForestNeuSModel
    from nr3d_lib_tpu_torch.models.grid_encodings.lotd import LoTDEncoding
    from nr3d_lib_tpu_torch.models.model_base import (LoTDNeRFModel,
                                                      LoTDNeuSModel)

    o, d = (torch.from_numpy(a) for a in _rays(N_RAYS_OBJ, seed=2))
    o, d = o.to(dev), d.to(dev)

    # ------------------- examples/train_neus_object.py (default flags)
    neus = _pretrained(LoTDNeuSModel, OBJ_XLA_CFG, dev, "neus_obj_xla")
    enc = neus.field.implicit_surface.encoding
    _require(isinstance(enc, LoTDEncoding), "the object NeuS's default "
             "encoding is not the classic LoTD")
    print(f"[neus_obj_xla] classic LoTD: res {list(enc.meta.level_res)}, "
          f"sizes {list(enc.meta.level_sizes)}, {enc.meta.n_params} "
          f"parameters")
    cpu = _cpu_twin(neus, LoTDNeuSModel, OBJ_XLA_CFG)
    n_cpu = _cpu_rays(lambda oo, dd: cpu.ray_query(cpu.ray_test(oo, dd)),
                      o, d)
    launches, _ = _serve(neus, cpu, o, d, {"gather1d": 1},
                         "neus_obj_xla_serve_2048", smi, cpu_rays=n_cpu)
    paths["neus_obj_xla_serve_2048"] = (launches, N_RENDERS)
    _step_vs_cpu(neus, cpu, o, d, _cpu_seconds(
        lambda oo, dd: _obj_loss(cpu, oo, dd), o, d, n_try=256),
        "neus_obj_xla_train_2048", loss=_obj_loss)
    paths["neus_obj_xla_train_2048"] = (_train(
        neus, o, d, smi, "neus_obj_xla_train_2048", {"gather1d": 1}, {},
        loss_fn=_obj_loss, lr=OBJ_LR, gated=True, clip=OBJ_CLIP), N_STEPS)
    del neus, cpu

    # ------------------ examples/train_nerf_synthetic.py (default flags)
    nerf = LoTDNeRFModel(**NERF_XLA_CFG, seed=0)
    _require(isinstance(nerf.field.encoding, LoTDEncoding), "the NeRF's "
             "default encoding is not the classic LoTD")
    _seed_weights(nerf, nerf.field.encoding, 28)
    nerf.populate()
    cpu = _cpu_twin(nerf, LoTDNeRFModel, NERF_XLA_CFG)
    fixed, fixed_cpu = _FixedQuery(nerf), _FixedQuery(cpu)
    n_cpu = _cpu_rays(lambda oo, dd: fixed_cpu.ray_query(
        fixed_cpu.ray_test(oo, dd)), o, d)
    launches, _ = _serve(fixed, fixed_cpu, o, d, {},
                         "nerf_xla_fixed_serve_2048", smi, cpu_rays=n_cpu)
    paths["nerf_xla_fixed_serve_2048"] = (launches, N_RENDERS)
    _step_vs_cpu(nerf, cpu, o, d, _cpu_seconds(
        lambda oo, dd: _fixed_loss(cpu, oo, dd), o, d, n_try=256),
        "nerf_xla_fixed_train_2048", loss=_fixed_loss)
    paths["nerf_xla_fixed_train_2048"] = (_train(
        nerf, o, d, smi, "nerf_xla_fixed_train_2048", {}, {},
        loss_fn=_fixed_loss, lifecycle=False, lr=NERF_XLA_LR), N_STEPS)
    del nerf, cpu, fixed, fixed_cpu

    # ---------------- examples/train_forest_street.py (default flags)
    forest = LoTDForestNeuSModel(**FOREST_XLA_CFG, seed=0)
    enc = forest.field.implicit_surface.encoding
    _require(enc.backend == "xla", "the forest's default encoding is not "
             "the classic LoTD")
    _seed_weights(forest, enc, 29)
    forest.populate()
    print(f"[forest_xla] classic LoTD over {enc.n_trees} blocks: "
          f"{tuple(enc.flattened_params.shape)} parameters")
    cpu = _cpu_twin(forest, LoTDForestNeuSModel, FOREST_XLA_CFG)
    of, df = (torch.from_numpy(a).to(dev)
              for a in _street_rays(N_RAYS_OBJ, seed=3))
    n_cpu = _cpu_rays(lambda oo, dd: cpu.ray_query(cpu.ray_test(oo, dd)),
                      of, df)
    launches, _ = _serve(forest, cpu, of, df, {}, "forest_xla_serve_2048",
                         smi, cpu_rays=n_cpu)
    paths["forest_xla_serve_2048"] = (launches, N_RENDERS)
    ot, dt = (torch.from_numpy(a).to(dev)
              for a in _street_rays(N_RAYS_FOREST_TRAIN, seed=4))
    _step_vs_cpu(forest, cpu, ot, dt, _cpu_seconds(
        lambda oo, dd: _forest_loss(cpu, oo, dd), ot, dt, n_try=256),
        "forest_xla_train_1024", loss=_forest_loss)
    paths["forest_xla_train_1024"] = (_train(
        forest, ot, dt, smi, "forest_xla_train_1024", {}, {},
        loss_fn=_forest_loss, lr=1e-2, gated=True), N_STEPS)


def _dyn_xla_paths(dev, o, d, ts_extra, smi: str, paths: dict) -> None:
    """`DynamicPermutoNeuSModel` at its default field, the classic 4D
    lattice (plain PyTorch: no kernel launches), served and trained as
    path D."""
    import torch
    from nr3d_lib_tpu_torch.models.model_families import \
        DynamicPermutoNeuSModel

    m = DynamicPermutoNeuSModel(**DYN_XLA_CFG, seed=0)
    bank = m.field.implicit_surface.bank
    _require(bank.backend == "xla", "the default field is not the classic "
             "lattice")
    _seed_weights(m, bank, 27)
    m.populate()
    cpu = _cpu_twin(m, DynamicPermutoNeuSModel, DYN_XLA_CFG)
    print(f"[dyn_permuto_xla] classic lattice: {bank.meta.n_levels} levels "
          f"of {bank.meta.hashmap_sizes[0]} entries x "
          f"{bank.meta.level_n_feats[0]} features, d = {bank.meta.n_dims}")
    cpu_s = _cpu_seconds(lambda oo, dd: cpu.ray_query(
        _tested(cpu, oo, dd, ts_extra)), o, d, n_try=256)
    n_cpu = N_RAYS
    while n_cpu > 256 and cpu_s * n_cpu / N_RAYS > CPU_STEP_BUDGET_S:
        n_cpu //= 2
    launches, _ = _serve(m, cpu, o, d, {}, "dyn_permuto_xla_serve_4096", smi,
                         extra=ts_extra, cpu_rays=n_cpu)
    paths["dyn_permuto_xla_serve_4096"] = (launches, N_RENDERS)
    _step_vs_cpu(m, cpu, o, d, cpu_s, "dyn_permuto_xla_train_4096", ts_extra)
    paths["dyn_permuto_xla_train_4096"] = (_train(
        m, o, d, smi, "dyn_permuto_xla_train_4096", {}, {}, ts_extra),
        N_STEPS)


def _scene_rays(n: int, seed: int):
    """examples/train_dynamic_scene.py `sample_rays` from numpy: origins
    at radius 2 above the floor, aimed into ±0.3, ts in [-1, 1)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o[:, 1] = np.abs(o[:, 1]) * 0.5 + 0.2
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = rng.uniform(-0.3, 0.3, (n, 3)) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            rng.uniform(-1.0, 1.0, n).astype(np.float32))


def _shape_rays(n: int, seed: int):
    """examples/train_generative_shapes.py (and train_conditional_dynamic.
    py) `sample_rays` from numpy: origins at radius 2 aimed into ±0.2, an
    instance a ray, ts in [-1, 1)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = rng.uniform(-0.2, 0.2, (n, 3)) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            rng.integers(0, N_INSTANCES, n).astype(np.int32),
            rng.uniform(-1.0, 1.0, n).astype(np.float32))


def _seed_tables(tables, seed: int) -> None:
    """Table values in ±0.1 (the init is ±1e-4) from a numpy seed."""
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in tables:
            p.copy_(torch.from_numpy(rng.uniform(
                -0.1, 0.1, tuple(p.shape)).astype(np.float32)))


def _row(kernels, key: str) -> dict:
    return next(k for k in kernels if k["key"] == key)


def _seed_emer_occupancy(model) -> tuple:
    """After `populate`, occupancy values drawn around the threshold: the
    static grid's in [0, 2·thre), each time key's in [0, 1.2·thre). With
    the seeded weights every σ at a cell centre is near 1, so `populate`
    leaves both grids full, and a B5 that wrote ones or read the wrong
    cells would pass the lookups' and the render's comparisons. Returns
    the occupied shares of the static grid and of the any-time union,
    each required within (0.05, 0.95)."""
    import torch

    rng = np.random.default_rng(36)
    st, dyn = model.accel.static, model.accel.dynamic.occ
    with torch.no_grad():
        st.val_grid.copy_(torch.from_numpy(rng.uniform(
            0, 2 * st.occ_thre, tuple(st.val_grid.shape)).astype(np.float32)))
        dyn.val_grid.copy_(torch.from_numpy(rng.uniform(
            0, 1.2 * dyn.occ_thre, tuple(dyn.val_grid.shape)
        ).astype(np.float32)))
    shares = (float(st.occ().float().mean()),
              float(torch.any(dyn.occ(), 0).float().mean()))
    for what, share in zip(("static", "any-time union"), shares):
        _require(0.05 < share < 0.95, f"emernerf: the seeded {what} grid "
                 f"is {share:.4f} occupied, not part empty")
    return shares


def _emer_b5_phase(model, o, d, kernels) -> None:
    """B5 at the EmerNeRF render's two lookups — 2048 rays × 64 march
    candidates into the static grid and into the any-time union of the
    dynamic grids, each [16·16, 16] — against the plain take, exactly;
    added to B5's row."""
    import torch
    from nr3d_lib_tpu_torch.ops import gather1d as G
    from nr3d_lib_tpu_torch.ops import occgrid_march as OM

    s = model.n_march_steps
    rt = model.ray_test(o, d)
    o_n, d_n = model.space.normalize_rays(o, d)
    t, _, _ = OM.march_steps(rt["near"], rt["far"], s, 2.0 / s)
    shp = model.accel.static.resolution
    xs = [o_n[:, None, a] + d_n[:, None, a] * t for a in range(3)]
    row, lane, _ = OM.grid_rows_lanes(shp, *xs)
    row, lane = row.reshape(-1).contiguous(), lane.reshape(-1).contiguous()
    rl, ll = row.long(), lane.long()
    n = row.numel()
    out, errs = {}, []
    with torch.no_grad():
        for what, grid in (("static", model.accel.static.occ()),
                           ("dynamic", torch.any(
                               model.accel.dynamic.occ.occ(), 0))):
            values = grid.reshape(shp[0] * shp[1], shp[2]).to(torch.float32)
            errs.append(_check(f"B5 gather1d, EmerNeRF {what} grid "
                         f"{tuple(values.shape)}", n, [(
                             "values", _err(G.gather_rows_lanes(values, row,
                                                                lane),
                                            G.gather_rows_lanes_plain(
                                                values, row, lane)),
                             0.0, "a copy")]))
            ms = _time_ms(lambda: G.gather_rows_lanes(values, row, lane))
            plain_ms = _time_ms(
                lambda: G.gather_rows_lanes_plain(values, row, lane))
            library_ms = _time_ms(lambda: values[rl, ll])
            bound = _bound(n * 12 + values.numel() * 4, 0)
            print(f"[B5 gather1d, EmerNeRF {what} grid] {n:,} lookups: "
                  f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                  f"values[row, lane] {library_ms:.4f} ms | bound "
                  f"{bound[0]:.4f} ms ({bound[1]})")
            out.update({f"ms_emernerf_{what}": ms,
                        f"plain_ms_emernerf_{what}": plain_ms,
                        f"library_ms_emernerf_{what}": library_ms,
                        f"bound_ms_emernerf_{what}": bound[0]})
    row_ = _row(kernels, "gather1d")
    row_.update(out, n_emernerf=n,
                max_abs_err=max([row_["max_abs_err"]] + errs))


def _gen_cell_kernel_phase(model, o, d, bidx, kernels) -> None:
    """B10 and B13 at the d = 5 generative cell field's final query —
    2048 rays × 48 samples of [x, tanh(z)] with each ray's latent — against
    their plain versions; added to their rows (suffix `_gen5`)."""
    import torch
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    surf = model.field.implicit_surface
    bank = surf.bank
    meta, table = bank.meta, bank.flattened_params.detach()
    n_per_ray = 32 + 2 * 8
    with torch.no_grad():
        z = model._latents()[torch.clamp(bidx, min=0).long()]
        zz = torch.tanh(z * surf.z_scale) * 0.5 + 0.5
        x = torch.cat([_ray_points(o, d, n_per_ray, seed=34),
                       torch.repeat_interleave(zz, n_per_ray, 0)],
                      -1).contiguous()
        n, L, dim = x.shape[0], meta.n_levels, meta.n_dims
        table_bytes = table.numel() * 4
        label = f"generative cell field, N={n}, d={dim}, L={L}, " \
            f"{meta.total_rows} rows"
        y_p = PC.permuto_cell_encode_xla(x, table, meta)
        err_f = _check(f"B10 permuto_fwd, {label}", n, [(
            "y", _err(PC.permuto_cell_encode(x, table, meta), y_p),
            1e-5 + 1e-5 * float(y_p.abs().max()),
            f"{dim + 1} weighted vertices summed in another order")])
        ms_f = _time_ms(lambda: PC._fwd_cuda(x, table, meta))
        plain_f = _time_ms(lambda: PC.permuto_cell_encode_xla(
            x, table, meta), iters=5)
        bound_f = _bound(n * (4 * dim + 8 * L) + table_bytes,
                         n * L * (_simplex_ops(dim) + 4 * (dim + 1)))
        g = torch.randn(n, 2 * L, device=x.device, generator=torch.Generator(
            device=x.device).manual_seed(35))
        n_p = PC.permuto_cell_nablas_xla(g, x, table, meta)
        err_d = _check(f"B13 permuto_dydx, {label}", n, [(
            "nablas", _err(PC.permuto_cell_nablas(g, x, table, meta), n_p),
            1e-4 + 1e-4 * float(n_p.abs().max()),
            f"sums over {dim + 1} vertices × 2 feats × {L} levels through "
            f"the elevation Jacobian, in another order")])
        ms_d = _time_ms(lambda: PC._dydx_cuda(g, x, table, meta))
        plain_d = _time_ms(lambda: PC.permuto_cell_nablas_xla(
            g, x, table, meta), iters=5)
        bound_d = _b13_bound(n, dim, L, table_bytes)
    for key, name, ms, plain, bound, err in (
            ("permuto_fwd", "B10", ms_f, plain_f, bound_f, err_f),
            ("permuto_dydx", "B13", ms_d, plain_d, bound_d, err_d)):
        print(f"[{name} at the generative cell field] kernel {ms:.4f} ms | "
              f"plain {plain:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]})"
              f" | library: none")
        r = _row(kernels, key)
        r.update(ms_gen5=ms, plain_ms_gen5=plain, bound_ms_gen5=bound[0],
                 n_gen5=n, max_abs_err=max(r["max_abs_err"], err))


def _a12_paths(dev, smi: str, paths: dict, kernels) -> None:
    """The last three example trainers at their default flags (A12):
    EmerNeRF (examples/train_dynamic_scene.py: 2 B5 a render and a step,
    none at an occupancy update), the generative shapes
    (train_generative_shapes.py, the classic 7D lattice) and the
    conditional dynamic shapes (train_conditional_dynamic.py, the
    classic 8D lattice), both without kernel launches; then the generative
    model on the cell layout at d = 5 (4 B10 + 1 B13 a render). Each
    against its CPU twin on the rays it renders within
    CPU_RENDER_BUDGET_S, its step on those within CPU_STEP_BUDGET_A12_S."""
    import torch
    from nr3d_lib_tpu_torch.models.model_families import (
        DynamicGenerativeNeuSModel, EmerNeRFModel,
        GenerativePermutoNeuSModelBatched)

    def on_dev(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    # ---------------- examples/train_dynamic_scene.py (default flags)
    emer = EmerNeRFModel(**EMER_CFG, seed=0)
    f = emer.field
    _seed_tables([f.static_encoding.flattened_params,
                  f.dyn_bank.flattened_params], 30)
    t0 = time.perf_counter()
    emer.populate()
    torch.cuda.synchronize()
    populate_ms = (time.perf_counter() - t0) * 1e3
    full = (float(emer.accel.static.occ().float().mean()),
            float(emer.accel.dynamic.occ.occ().float().mean()))
    seeded = _seed_emer_occupancy(emer)
    print(f"[emernerf] static classic LoTD res "
          f"{list(f.static_encoding.meta.level_res)}, "
          f"{f.static_encoding.meta.n_params} parameters; dynamic classic "
          f"lattice d = {f.dyn_bank.meta.n_dims}, "
          f"{f.dyn_bank.meta.n_levels} levels of "
          f"{f.dyn_bank.meta.hashmap_sizes[0]}; populate {populate_ms:.1f} "
          f"ms; occupied share after populate: static {full[0]:.4f}, "
          f"dynamic {full[1]:.4f}; seeded: static {seeded[0]:.4f}, "
          f"any-time union {seeded[1]:.4f}")
    o, d, ts = on_dev(*_scene_rays(N_RAYS_OBJ, seed=5))
    extra = {"ts": ts}
    _emer_b5_phase(emer, o, d, kernels)
    cpu = _cpu_twin(emer, EmerNeRFModel, EMER_CFG)
    n_cpu = _cpu_rays(lambda oo, dd: cpu.ray_query(_tested(cpu, oo, dd,
                                                           extra)), o, d)
    launches, _ = _serve(emer, cpu, o, d, {"gather1d": 2},
                         "emernerf_serve_2048", smi, extra=extra,
                         cpu_rays=n_cpu)
    paths["emernerf_serve_2048"] = (launches, N_RENDERS)
    _step_vs_cpu(emer, cpu, o, d, _cpu_seconds(
        lambda oo, dd: _emer_loss(cpu, oo, dd, extra), o, d, n_try=256),
        "emernerf_train_2048", extra, loss=_emer_loss,
        budget_s=CPU_STEP_BUDGET_A12_S)
    paths["emernerf_train_2048"] = (_train(
        emer, o, d, smi, "emernerf_train_2048", {"gather1d": 2}, {}, extra,
        loss_fn=_emer_loss, lr=EMER_LR, gated=True), N_STEPS)
    union = torch.any(emer.accel.dynamic.occ.occ(), 0)
    print(f"[emernerf] occupied share after the steps' dynamic updates: "
          f"static {float(emer.accel.static.occ().float().mean()):.4f}, "
          f"any-time union {float(union.float().mean()):.4f}")
    del emer, cpu

    # ---- train_generative_shapes.py and train_conditional_dynamic.py
    o, d, bidx, ts = on_dev(*_shape_rays(N_RAYS_OBJ, seed=6))
    for label, cls, cfg, seed, extra in (
            ("gen_shapes", GenerativePermutoNeuSModelBatched, GEN_CFG, 31,
             {"bidx": bidx}),
            ("cond_dyn", DynamicGenerativeNeuSModel, COND_DYN_CFG, 32,
             {"bidx": bidx, "ts": ts})):
        m = cls(**cfg, seed=0)
        bank = m.field.implicit_surface.bank
        _require(bank.backend == "xla", f"{label}: the default field is not "
                 f"the classic lattice")
        _seed_weights(m, bank, seed)
        print(f"[{label}] classic lattice d = {bank.meta.n_dims}, "
              f"{bank.meta.n_levels} levels of {bank.meta.hashmap_sizes[0]} "
              f"entries, {N_INSTANCES} instances of latent_dim "
              f"{m.autodecoder.latent_dim}")
        cpu = _cpu_twin(m, cls, cfg)
        n_cpu = _cpu_rays(lambda oo, dd: cpu.ray_query(_tested(
            cpu, oo, dd, extra)), o, d)
        launches, _ = _serve(m, cpu, o, d, {}, f"{label}_serve_2048", smi,
                             extra=extra, cpu_rays=n_cpu)
        paths[f"{label}_serve_2048"] = (launches, N_RENDERS)
        _step_vs_cpu(m, cpu, o, d, _cpu_seconds(
            lambda oo, dd: _gen_loss(cpu, oo, dd, extra), o, d, n_try=256),
            f"{label}_train_2048", extra, loss=_gen_loss,
            budget_s=CPU_STEP_BUDGET_A12_S)
        paths[f"{label}_train_2048"] = (_train(
            m, o, d, smi, f"{label}_train_2048", {}, {}, extra,
            loss_fn=_gen_loss, lr=GEN_LR, gated=True, clip=GEN_CLIP),
            N_STEPS)
        del m, cpu

    # ------------- the generative model on the cell layout (d = 5)
    m = GenerativePermutoNeuSModelBatched(**GEN_CELL_CFG, seed=0)
    bank = m.field.implicit_surface.bank
    _require(bank.backend == "cell" and bank.meta.n_dims == 5,
             "gen_cell: not the d = 5 cell layout")
    _seed_weights(m, bank, 33)
    print(f"[gen_cell] F=2 cell layout d = 5: {bank.meta.n_levels} levels, "
          f"{bank.meta.total_rows} rows")
    _gen_cell_kernel_phase(m, o, d, bidx, kernels)
    cpu = _cpu_twin(m, GenerativePermutoNeuSModelBatched, GEN_CELL_CFG)
    extra = {"bidx": bidx}
    n_cpu = _cpu_rays(lambda oo, dd: cpu.ray_query(_tested(cpu, oo, dd,
                                                           extra)), o, d)
    launches, _ = _serve(m, cpu, o, d, {"permuto_fwd": 4, "permuto_dydx": 1},
                         "gen_cell_serve_2048", smi, extra=extra,
                         cpu_rays=n_cpu)
    paths["gen_cell_serve_2048"] = (launches, N_RENDERS)


def _getter_accel_vs_cpu(model, cpu, o, d) -> None:
    """The getter grid's update on the card (one B1 launch for the cell
    centres) against the CPU twin's from the same weights: equal except
    cells whose value lies within 1e-5 of the threshold. Then, on the same
    grid, bitwise: `query` (one B5 launch) at the render's points and
    outside the box, `debug_stats`, `try_shrink` (None); and the EMA
    grid's `collect_samples`, `try_shrink` and `occupancy_ratio` from the
    same values and points."""
    import torch
    from nr3d_lib_tpu_torch.models.accelerations import (OccGridAccel,
                                                         cell_centers)
    from nr3d_lib_tpu_torch.ops import _build

    occ, res = model.accel.occ, model.accel.occ.resolution
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        occ.update(model.query_occ_val)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        cpu.accel.occ.update(cpu.query_occ_val)
        vals = cpu.query_occ_val(cell_centers(res)).reshape(res)
    near = (vals.abs() - occ.occ_thre).abs() < 1e-5
    diff = occ.occ_grid.cpu() != cpu.accel.occ.occ_grid
    share = float(occ.occ_grid.float().mean())
    print(f"[neus_obj_w4_getter accel] update of the {tuple(res)} grid: "
          f"launches {launches}; occupied share {share:.4f}; "
          f"{int(diff.sum())} cells "
          f"differ from the CPU's ({int(near.sum())} lie within 1e-5 of "
          f"the threshold, {int((diff & ~near).sum())} differing outside "
          f"that band; tolerance 0)")
    _require(launches == {"brick4_fwd": 1}, "the getter update did not "
             "launch B1 once")
    _require(not bool((diff & ~near).any()), "the getter grids disagree")
    _require(0.02 < share < 0.9, "the getter grid is trivially full or "
             "empty")
    cpu.accel.occ.occ_grid.copy_(occ.occ_grid.cpu())
    x = torch.cat([_ray_points(o, d, 96, seed=71) * 2.0 - 1.0,
                   torch.rand(4096, 3, generator=torch.Generator(
                       o.device).manual_seed(72), device=o.device) * 2.4
                   - 1.2])
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    q = model.accel.query(x)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    same_q = torch.equal(q.cpu(), cpu.accel.query(x.cpu()))
    stats = (model.accel.debug_stats(), cpu.accel.debug_stats())
    print(f"[neus_obj_w4_getter accel] query of {x.shape[0]} points: "
          f"launches {launches}, bitwise the CPU's: {same_q}; debug_stats "
          f"{stats[0]} / {stats[1]}; try_shrink "
          f"{model.accel.try_shrink()} / {cpu.accel.try_shrink()}")
    _require(launches == {"gather1d": 1} and same_q, "the getter query")
    _require(stats[0] == stats[1] and model.accel.try_shrink() is None,
             "the getter's stats")
    with torch.no_grad():
        xv = cpu.query_occ_val(x.cpu())
    ema = []
    for dev in (o.device, torch.device("cpu")):
        a = OccGridAccel(resolution=res, device=dev)
        a.occ.val_grid.copy_(vals)
        a.collect_samples(x.to(dev), xv.to(dev))
        ema.append((a.occ.val_grid.cpu(), a.try_shrink().cpu(),
                    float(a.occ.occupancy_ratio())))
    same = [torch.equal(ema[0][0], ema[1][0]),
            torch.equal(ema[0][1], ema[1][1]), ema[0][2] == ema[1][2]]
    print(f"[neus_obj_w4_getter accel] the EMA grid from the same values: "
          f"collect_samples of {x.shape[0]} points, try_shrink "
          f"{ema[0][1].tolist()}, occupancy_ratio {ema[0][2]:.4f}; bitwise "
          f"the CPU's (grid, box, ratio): {same}")
    _require(all(same), "the EMA grid's collect_samples or try_shrink")


def _mlp_field_phase(dev, smi: str, paths: dict) -> None:
    """The MLP-only fields at JAX's defaults, each its own entry point
    (`device=None` is the card): `MlpNeuS` (MlpSDF D 8, W 256, skip at 4,
    softplus β = 100, geometric init r = 0.5; RadianceNet D 2, W 64),
    `MlpNeRF` (D 4, W 128, 6 frequencies) and `LipshitzMLP` (3 → 4, D 4,
    W 128; its bounds moved off the init's clamp corner) on 4,096 rays ×
    64 points: the forward (the NeuS's sdf, nablas
    and rgb) and a step (the NeuS's eikonal loss backward through the
    nablas' second order), each timed with CUDA events, no kernel of the
    port launched; held against the CPU route from the same weights on
    the first N_MLP_CPU points (values within 1e-5 + 1e-4 of the largest
    entry, the loss within 1e-4 relative, each gradient within 1e-2
    relative L2: PERF.md §2)."""
    import torch
    from nr3d_lib_tpu_torch.models.blocks import LipshitzMLP
    from nr3d_lib_tpu_torch.models.fields import MlpNeRF, MlpNeuS
    from nr3d_lib_tpu_torch.ops import _build

    o, d = (torch.from_numpy(a).to(dev) for a in _rays(N_RAYS, seed=3))
    x = _ray_points(o, d, N_MLP_PER_RAY, seed=73) * 2.0 - 1.0
    v = d[:, None, :].expand(-1, N_MLP_PER_RAY, -1).reshape(-1, 3)
    n = x.shape[0]

    def neus(m, xx, vv):
        out = m(xx, vv)
        eik = torch.mean((torch.linalg.norm(out["nablas"], dim=-1) - 1.0)
                         ** 2)
        return out, torch.mean((out["rgb"] - vv.abs()) ** 2) + 0.1 * eik

    def nerf(m, xx, vv):
        out = m(xx, vv)
        return out, torch.mean((out["rgb"] - vv.abs()) ** 2) + \
            1e-3 * torch.mean(out["sigma"])

    def lip(m, xx, vv):
        y = m(xx)
        return {"y": y}, torch.mean((y[:, :3] - vv.abs()) ** 2) + \
            1e-3 * m.lipshitz_bound_full()

    for name, cls, run in (
            ("mlp_neus", MlpNeuS, neus), ("mlp_nerf", MlpNeRF, nerf),
            ("lipshitz", lambda seed, device=dev: LipshitzMLP(
                3, 4, seed=seed, device=device), lip)):
        m = cls(seed=0)
        _require(next(m.parameters()).device.type == "cuda",
                 f"{name}: device=None did not resolve to the card")
        if name == "lipshitz":
            # the init puts every layer on the corner of min(1, bound /
            # |w|), where a last-ulp difference picks the other gradient
            # (ROADMAP §C): the bounds move off it, alternately below
            # (the weights scaled) and above
            with torch.no_grad():
                for i, c in enumerate(m.cs):
                    c.add_(-0.3 if i % 2 == 0 else 0.3)
        mc = cls(seed=0, device="cpu")
        mc.load_state_dict({k: t.cpu() for k, t in m.state_dict().items()})
        xc, vc = x[:N_MLP_CPU], v[:N_MLP_CPU]
        m.zero_grad(set_to_none=True)
        out, loss = run(m, xc, vc)
        loss.backward()
        out_c, loss_c = run(mc, xc.cpu(), vc.cpu())
        loss_c.backward()
        parts = []
        for k, ref in out_c.items():
            ref = ref.detach()
            parts.append((k, _err(out[k].detach().cpu(), ref),
                          1e-5 + 1e-4 * float(ref.abs().max()),
                          "the matmuls sum in another order"))
        _check(f"field {name} vs cpu", N_MLP_CPU, parts)
        loss, loss_c = float(loss.detach()), float(loss_c.detach())
        rel = abs(loss - loss_c) / abs(loss_c)
        errs = {k: float(torch.linalg.norm(a.grad.cpu() - b.grad) /
                         max(float(torch.linalg.norm(b.grad)), 1e-12))
                for (k, a), b in zip(m.named_parameters(), mc.parameters())
                if b.grad is not None}
        print(f"[field {name} step vs cpu] {N_MLP_CPU} points: loss "
              f"relative {rel:.2e} (tolerance 1e-4); gradients, relative L2 "
              f"(tolerance 1e-2): max {max(errs.values()):.2e} over "
              f"{len(errs)} tensors")
        _require(rel <= 1e-4, f"{name}: card and CPU losses disagree")
        _require(max(errs.values()) <= 1e-2,
                 f"{name}: card and CPU gradients disagree")
        del mc

        def fwd():
            with torch.no_grad():
                return run(m, x, v)

        def step():
            m.zero_grad(set_to_none=True)
            run(m, x, v)[1].backward()

        for what, fn in (("forward", fwd), ("step", step)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.LAUNCHES.clear()
            fn()
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            ms = _time_ms(fn, iters=5, warmup=1)
            print(f"[field {name} {what}] {n} points on {smi}: {ms:.3f} ms "
                  f"device time per call, peak memory {peak:.1f} MiB; "
                  f"launches {launches}")
            _require(launches == {}, f"{name}: a kernel of the port "
                     f"launched")
            paths[f"field {name} {what}"] = (launches, 1)
        del m


def _a19_paths(dev, smi: str, paths: dict) -> None:
    """The occupancy leftovers and the rest of the ported layers (A7c,
    A19): the --w4 object model with the use_ema=False getter grid,
    served (4 B1 + 1 B3 + 1 B5 a render) and trained as the example
    trains it (4 B1 + 1 B2 + 1 B3 + 1 B4 + 1 B5 a step, +1 B1 at each
    getter update), its accel against the CPU twin; the MLP-only fields;
    the default classic-LoTD object model in bf16 compute, served once
    and one step, against the CPU bf16 route."""
    import torch
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    o, d = (torch.from_numpy(a).to(dev) for a in _rays(N_RAYS_OBJ, seed=2))

    # --------- examples/train_neus_object.py --w4, use_ema=False getter
    w4 = _pretrained(LoTDNeuSModel, OBJ_W4_GETTER_CFG, dev,
                     "neus_obj_w4_getter")
    _require(not w4.accel.use_ema and
             w4.accel.occ.occ_grid.dtype == torch.bool,
             "the getter model has no bool getter grid")
    cpu = _cpu_twin(w4, LoTDNeuSModel, OBJ_W4_GETTER_CFG)
    launches, _ = _serve(w4, cpu, o, d, {"brick4_fwd": 4, "brick4_dydx": 1,
                                         "gather1d": 1},
                         "neus_obj_w4_getter_serve_2048", smi)
    paths["neus_obj_w4_getter_serve_2048"] = (launches, N_RENDERS)
    _getter_accel_vs_cpu(w4, cpu, o, d)
    _step_vs_cpu(w4, cpu, o, d, _cpu_seconds(
        lambda oo, dd: _obj_loss(cpu, oo, dd), o, d),
        "neus_obj_w4_getter_train_2048", loss=_obj_loss)
    paths["neus_obj_w4_getter_train_2048"] = (_train(
        w4, o, d, smi, "neus_obj_w4_getter_train_2048",
        {"brick4_fwd": 4, "brick4_dydx": 1, "gather1d": 1, "brick4_bwd": 1,
         "brick4_bwd2": 1}, {"brick4_fwd": 1}, loss_fn=_obj_loss,
        lr=OBJ_LR, gated=True, clip=OBJ_CLIP), N_STEPS)
    del w4, cpu

    # ------------------------------------------ the MLP-only fields
    _mlp_field_phase(dev, smi, paths)

    # ------- examples/train_neus_object.py (default flags), bf16 compute
    bf = _pretrained(LoTDNeuSModel, OBJ_XLA_BF16_CFG, dev, "neus_obj_xla_bf16")
    enc = bf.field.implicit_surface.encoding
    with torch.no_grad():
        out = bf.forward_sdf_nablas(o[:8] * 0.1)
    print(f"[neus_obj_xla_bf16] compute {enc.compute_dtype}, parameters "
          f"{enc.flattened_params.dtype}: sdf {out['sdf'].dtype}, h "
          f"{out['h'].dtype}, nablas {out['nablas'].dtype}")
    _require(out["sdf"].dtype == torch.bfloat16 and
             out["nablas"].dtype == torch.float32, "the bf16 dtypes")
    cpu = _cpu_twin(bf, LoTDNeuSModel, OBJ_XLA_BF16_CFG)
    n_cpu = _cpu_rays(lambda oo, dd: cpu.ray_query(cpu.ray_test(oo, dd)),
                      o, d)
    launches, _ = _serve(bf, cpu, o, d, {"gather1d": 1},
                         "neus_obj_xla_bf16_serve_2048", smi, n_renders=1,
                         cpu_rays=n_cpu, tol=BF16_TOL)
    paths["neus_obj_xla_bf16_serve_2048"] = (launches, 1)
    _step_vs_cpu(bf, cpu, o, d, _cpu_seconds(
        lambda oo, dd: _obj_loss(cpu, oo, dd), o, d, n_try=256),
        "neus_obj_xla_bf16_train_2048", loss=_obj_loss,
        loss_tol=BF16_LOSS_TOL, grad_tol=BF16_GRAD_TOL)


DMTET_RES = 128          # examples/train_neus_object.py --mesh_res
DMTET_DEFORM_L2 = 1e-3
POSE_HW = 400
POSE_LR = 2e-3
N_PACKS, PACK_S = 4096, 96         # the F=4 bench render's buffer
N_ROT = 1 << 20
DEPTH_HW = (1280, 1920)            # a Waymo front camera
KNN_CHUNK = 2048                   # a [2048, 500,000] block: 4.1 GB
N_KNN_CHECK = 4096


def _device_kernel_counts(run) -> dict:
    """{kernel name: launches} of the port's kernels in one call of `run`,
    read from torch.profiler's device events."""
    from torch.autograd import DeviceType

    prof = _profiled(run, 1)
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.key.removeprefix("void ").split("(")[0].split("<")[0]
        if name.startswith(("brick", "gather1d", "occ_march", "permuto",
                             "gs_blend")):
            out[name] = out.get(name, 0) + ev.count
    return out


def _need_dx_log(module, names):
    """Wrap the backward wrappers `names` of `module` so that each call
    appends (name, need_dx) to the returned list; `restore()` undoes it."""
    log, saved = [], {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def inner(*a, **kw):
            log.append((name, bool(kw.get("need_dx", True))))
            return fn(*a, **kw)
        return inner

    for n in names:
        setattr(module, n, wrap(n, saved[n]))

    def restore():
        for n, fn in saved.items():
            setattr(module, n, fn)
    return log, restore


def _dmtet_loss(tv, m, deform):
    """JAX's test loss (tests/test_mesh_gs_misc.py: Σ over the valid
    corners of (|v| − 0.4)²) plus DMTET_DEFORM_L2·Σ deform²."""
    import torch

    r = torch.linalg.norm(tv, dim=-1)
    return torch.sum(torch.where(m[..., None], (r - 0.4) ** 2,
                                 torch.zeros_like(r))) + \
        DMTET_DEFORM_L2 * torch.sum(deform ** 2)


def _dmtet_phase(model, cpu, smi: str, paths: dict) -> None:
    """DMTet at resolution 128 over the --w4 object SDF: the extraction
    (1 B1 at 2,097,152 vertices) and one Adam step on the table and a
    deformation (1 B2 without dL/dx: the grid's positions carry no
    gradient), each against the CPU route given the card's SDF values."""
    import torch
    from nr3d_lib_tpu_torch.models.tetrahedral import DMTet
    from nr3d_lib_tpu_torch.ops import _build
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    dev = next(model.parameters()).device
    surf = model.field.implicit_surface
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    dm = DMTet(resolution=DMTET_RES, device=dev)
    torch.cuda.synchronize()
    n_v, n_t = dm.base_verts.shape[0], dm.tets.shape[0]
    print(f"[dmtet_w4] grid {DMTET_RES}³: {n_v} vertices, {n_t} tets, "
          f"built on the card in {time.perf_counter() - t0:.2f} s")

    def extract():
        with torch.no_grad():
            sdf = surf.forward_sdf(dm.base_verts)["sdf"]
            return (sdf,) + tuple(dm(sdf))

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    sdf, tv, mask, bits = extract()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    counts = _device_kernel_counts(extract)
    ms = _time_ms(extract, iters=3, warmup=1)
    t0 = time.perf_counter()
    extract()
    torch.cuda.synchronize()
    _profile(extract, (time.perf_counter() - t0) * 1e3, "DMTet extraction")
    t0 = time.perf_counter()
    verts, faces = dm.to_mesh(tv, mask)
    mesh_s = time.perf_counter() - t0
    med = float(np.median(np.linalg.norm(verts, axis=-1)))
    print(f"[dmtet_w4_extract_128] on {smi}: {ms:.3f} ms device time (the "
          f"SDF at {n_v} vertices and the marching tets, CUDA events); "
          f"{int(mask.sum())} valid triangles; to_mesh (host, numpy) "
          f"{mesh_s:.2f} s: {len(verts)} vertices, {len(faces)} faces, "
          f"median radius {med:.5f} (tolerance 0.02 of 0.5); launches "
          f"{launches}, by the profiler {counts}")
    _require(launches == {"brick4_fwd": 1} and
             counts == {"brick4_fwd_kernel": 1},
             "the extraction did not launch B1 once")
    _require(abs(med - 0.5) <= 0.02, "the DMTet surface is not the sphere")
    paths["dmtet_w4_extract_128"] = (launches, 1)

    # the CPU model's SDF at the same vertices, and the CPU route of the
    # marching tets from the card's SDF values
    t0 = time.perf_counter()
    cpu_dm = DMTet(resolution=DMTET_RES, device="cpu")
    with torch.no_grad():
        sdf_c = cpu.field.implicit_surface.forward_sdf(
            cpu_dm.base_verts)["sdf"]
    e_sdf = _err(sdf.cpu(), sdf_c)
    s_cpu = sdf.detach().cpu().requires_grad_(True)
    d_cpu = torch.zeros(n_v, 3, requires_grad=True)
    tv_c, mask_c, bits_c = cpu_dm(s_cpu, d_cpu)
    _dmtet_loss(tv_c, mask_c, d_cpu).backward()
    cpu_s = time.perf_counter() - t0

    # the step: one Adam step on the table and the deformation
    deform = torch.zeros(n_v, 3, device=dev, requires_grad=True)
    opt = torch.optim.Adam(list(surf.encoding.parameters()) + [deform],
                           lr=1e-3)
    log, restore = _need_dx_log(B4, ["_bwd_cuda"])
    out = {}

    def step():
        opt.zero_grad(set_to_none=True)
        s = surf.forward_sdf(dm.base_verts)["sdf"]
        s.retain_grad()
        tv_, m_, b_ = dm(s, deform)
        loss = _dmtet_loss(tv_, m_, deform)
        loss.backward()
        opt.step()
        out.update(sdf=s, tv=tv_, mask=m_, bits=b_, loss=loss.detach())

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step()
        ev[1].record()
        torch.cuda.synchronize()
        step_ms = ev[0].elapsed_time(ev[1])
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        need_dx = list(log)
        g_sdf, g_def = out["sdf"].grad.cpu(), deform.grad.cpu()
        tv_g, mask_g, bits_g = (out[k].detach().cpu()
                                for k in ("tv", "mask", "bits"))
        counts = _device_kernel_counts(step)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        _profile(step, (time.perf_counter() - t0) * 1e3, "DMTet step")
    finally:
        restore()
        model.load_state_dict(snapshot)

    same_bits = torch.equal(bits_g, bits_c) and torch.equal(mask_g, mask_c)
    e_tv = _err(tv_g, tv_c.detach())

    def rel(a, b):
        return float(torch.linalg.norm(a - b) /
                     max(float(torch.linalg.norm(b)), 1e-30))

    r_sdf, r_def = rel(g_sdf, s_cpu.grad), rel(g_def, d_cpu.grad)
    print(f"[dmtet_w4_step_128] on {smi}: one step (forward_sdf, the "
          f"marching tets, loss {float(out['loss']):.6e}, backward, Adam) "
          f"{step_ms:.3f} ms (CUDA events), peak memory {peak:.1f} MiB; "
          f"launches {launches}, by the profiler {counts}, B2 need_dx "
          f"{need_dx}")
    print(f"[dmtet_w4 vs cpu] the CPU route ({cpu_s:.1f} s) given the "
          f"card's SDF: SDF values max|card - cpu model| {e_sdf:.3e} "
          f"(tolerance 1e-5); mask_bits and tri_mask bitwise: {same_bits}; "
          f"tri_verts max|card - cpu| {e_tv:.3e} (tolerance 1e-5); "
          f"gradients, relative L2: the SDF values {r_sdf:.3e}, the "
          f"deformation {r_def:.3e} (tolerance 1e-4)")
    _require(e_sdf <= 1e-5, "the card's and the CPU's SDF values disagree")
    _require(same_bits and e_tv <= 1e-5, "DMTet's card and CPU routes "
             "disagree")
    _require(max(r_sdf, r_def) <= 1e-4, "DMTet's gradients disagree")
    _require(launches == {"brick4_fwd": 1, "brick4_bwd": 1} and
             need_dx == [("_bwd_cuda", False)] and
             counts.get("brick4_fwd_kernel") == 1 and
             counts.get("brick4_bwd_kernel") == 1,
             "the DMTet step did not launch B1 and B2 (without dL/dx) once")
    paths["dmtet_w4_step_128"] = (launches, 1)


def _rot_err_deg(a, b) -> float:
    """The angle of a·bᵀ for 3×3 rotations, in degrees."""
    c = (float(np.trace(a @ b.T)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _pose_phase(model, cpu, smi: str, paths: dict) -> None:
    """Pose refinement through the render: an OpenCV camera at radius 2,
    its pose TransformExpSE3 ∘ TransformRT with the ExpSE3 started 2° and
    0.02 off, 2048 pixels, the field frozen; Adam on (w, v, θ)."""
    import torch
    from nr3d_lib_tpu_torch.graphics.cameras import look_at
    from nr3d_lib_tpu_torch.models.attributes import (
        OpenCVCameraIntrinsics, TransformExpSE3, TransformRT)
    from nr3d_lib_tpu_torch.ops import _build
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    dev = next(model.parameters()).device
    rng = np.random.default_rng(41)
    f = 1.2 * POSE_HW            # the sphere fills ~30% of the image
    dist = rng.uniform(-1.0, 1.0, 4) * np.asarray([2e-2, 1e-2, 5e-3, 5e-3])

    def camera(device):
        def t(x):
            return torch.tensor(np.float32(x), device=device)
        return OpenCVCameraIntrinsics(
            t(f), t(f), t(POSE_HW / 2), t(POSE_HW / 2), POSE_HW, POSE_HW,
            dist=torch.tensor(dist.astype(np.float32), device=device))

    eye = rng.normal(size=3)
    eye = eye / np.linalg.norm(eye) * 2.0
    gt = TransformRT.from_mat4x4(look_at(eye, (0.0, 0.0, 0.0), device=dev))
    axis = rng.normal(size=3)
    axis = axis / np.linalg.norm(axis)
    th0 = np.deg2rad(2.0)
    vdir = rng.normal(size=3)
    vdir = vdir / np.linalg.norm(vdir)
    init = {"w": axis, "v": vdir * 0.02 / th0, "theta": th0}
    pix = rng.choice(POSE_HW * POSE_HW, N_RAYS_OBJ, replace=False)
    uv = np.stack([pix % POSE_HW, pix // POSE_HW], -1).astype(np.float32) \
        + 0.5

    def rays(intr, delta, rt, uv_):
        c2w = delta.mat_4x4() @ rt.mat_4x4()
        d = torch.einsum("ij,nj->ni", c2w[:3, :3], intr.lift(uv_))
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return c2w[:3, 3].expand(d.shape), d

    def delta_of(device):
        return TransformExpSE3(*(
            torch.tensor(np.asarray(init[k], np.float32), device=device,
                         requires_grad=True) for k in ("w", "v", "theta")))

    def render(m, intr, delta, rt, uv_):
        o, d = rays(intr, delta, rt, uv_)
        return m.ray_query(m.ray_test(o, d))[0]["rgb_volume"]

    intr, uv_g = camera(dev), torch.from_numpy(uv).to(dev)
    ident = TransformExpSE3.identity(device=dev)
    for m in (model, cpu):
        for p in m.parameters():
            p.requires_grad_(False)
    try:
        with torch.no_grad():
            target = render(model, intr, ident, gt, uv_g)
        hit = float((target.abs().sum(-1) > 1e-3).float().mean())

        # step 1, card against the CPU route from the same pose
        delta = delta_of(dev)
        loss_g = torch.mean((render(model, intr, delta, gt, uv_g)
                             - target) ** 2)
        loss_g.backward()
        t0 = time.perf_counter()
        gt_c = TransformRT(gt.rot.detach().cpu(), gt.trans.detach().cpu())
        delta_c = delta_of("cpu")
        loss_c = torch.mean((render(cpu, camera("cpu"), delta_c, gt_c,
                                    torch.from_numpy(uv)) - target.cpu())
                            ** 2)
        loss_c.backward()
        cpu_s = time.perf_counter() - t0
        rel_loss = abs(float(loss_g.detach()) - float(loss_c.detach())) / \
            abs(float(loss_c.detach()))
        errs = {k: float(torch.linalg.norm(a.grad.cpu() - b.grad) /
                         max(float(torch.linalg.norm(b.grad)), 1e-30))
                for k, a, b in zip(("w", "v", "theta"), delta.parameters(),
                                   delta_c.parameters())}
        print(f"[neus_obj_w4_pose step vs cpu] {N_RAYS_OBJ} rays ({hit:.4f} "
              f"of them rendered, rgb > 1e-3), CPU step {cpu_s:.1f} s: loss "
              f"card {float(loss_g.detach()):.7e} cpu "
              f"{float(loss_c.detach()):.7e}, relative {rel_loss:.2e} "
              f"(tolerance 1e-4); gradients, relative L2 (tolerance 1e-2): "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
        _require(rel_loss <= 1e-4, "pose step: card and CPU losses disagree")
        _require(max(errs.values()) <= 1e-2,
                 "pose step: card and CPU gradients disagree")
        _require(hit > 0.1, "the pose camera sees too little of the object")

        # the refinement: 2 warm-up and N_STEPS timed steps
        delta = delta_of(dev)
        opt = torch.optim.Adam(delta.parameters(), lr=POSE_LR)
        losses, errs_at = [], []

        def step():
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((render(model, intr, delta, gt, uv_g)
                               - target) ** 2)
            loss.backward()
            opt.step()
            losses.append(loss.detach())

        def pose_err():
            with torch.no_grad():
                a = (delta.mat_4x4() @ gt.mat_4x4()).cpu().numpy()
                b = gt.mat_4x4().cpu().numpy()
            return _rot_err_deg(a[:3, :3], b[:3, :3]), \
                float(np.linalg.norm(a[:3, 3] - b[:3, 3]))

        errs_at.append(pose_err())
        for _ in range(N_WARMUP_STEPS):
            step()
        losses.clear()
        log, restore = _need_dx_log(B4, ["_bwd_cuda", "_bwd2_cuda"])
        try:
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            times = []
            for _ in range(N_STEPS):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            launches = dict(_build.LAUNCHES)
            need_dx = list(log)
            errs_at.append(pose_err())
            counts = _device_kernel_counts(step)
            _profile(step, statistics.median(times), "pose step")
        finally:
            restore()
        ls = [float(x) for x in losses[:N_STEPS]]
        med = statistics.median(times)
        print(f"[neus_obj_w4_pose_train_2048] on {smi}: {med:.3f} ms a step "
              f"(median of {N_STEPS}; quartiles "
              f"{np.percentile(times, 25):.3f}/{np.percentile(times, 75):.3f}"
              f"), loss {ls[0]:.6e} → {ls[N_STEPS - 1]:.6e} (the last 5's "
              f"mean {np.mean(ls[N_STEPS - 5:N_STEPS]):.6e}); rotation error "
              f"{errs_at[0][0]:.4f}° → {errs_at[1][0]:.4f}°, translation "
              f"{errs_at[0][1]:.5f} → {errs_at[1][1]:.5f}; launches in "
              f"{N_STEPS} steps {launches}; one more step by the profiler "
              f"{counts}")
        per = {k: v / N_STEPS for k, v in launches.items()}
        dx_b2 = [dx for n, dx in need_dx if n == "_bwd_cuda"]
        dx_b4 = [dx for n, dx in need_dx if n == "_bwd2_cuda"]
        _require(np.mean(ls[N_STEPS - 5:N_STEPS]) < ls[0],
                 "the pose refinement's loss did not fall")
        _require(per.get("brick4_fwd_g", 0) >= 1 and
                 per.get("brick4_bwd", 0) >= 1 and
                 per.get("brick4_bwd2", 0) >= 1 and
                 len(dx_b2) == len(dx_b4) == N_STEPS and all(dx_b2) and
                 all(dx_b4) and counts.get("brick4_fwd_g_kernel", 0) >= 1 and
                 counts.get("brick4_bwd_kernel", 0) >= 1 and
                 counts.get("brick4_bwd2_kernel", 0) >= 1,
                 "the pose step did not run B1 want_g, and B2 and B4 with "
                 "dL/dx, each step")
        paths["neus_obj_w4_pose_train_2048"] = (launches, N_STEPS)
    finally:
        for m in (model, cpu):
            for p in m.parameters():
                p.requires_grad_(True)


def _pack_inputs(dev):
    """The F=4 bench render's packed buffer: 4096 packs of 0 … 96 seeded
    samples (a tenth of them empty), the padding at the end."""
    import torch

    rng = np.random.default_rng(42)
    counts = rng.integers(0, PACK_S + 1, N_PACKS)
    counts[rng.uniform(size=N_PACKS) < 0.1] = 0
    cap = N_PACKS * PACK_S
    n = int(counts.sum())
    ridx = np.full(cap, N_PACKS, np.int32)
    ridx[:n] = np.repeat(np.arange(N_PACKS), counts)
    t = np.zeros(cap, np.float32)
    t[:n] = np.concatenate([np.sort(rng.uniform(0.5, 4.0, c))
                            for c in counts if c]).astype(np.float32)
    w = rng.uniform(0, 1, cap).astype(np.float32)
    cdf = np.zeros(cap, np.float32)
    o = 0
    for c in counts:
        if c:
            cw = np.cumsum(w[o:o + c])
            cdf[o:o + c] = cw / cw[-1]
            cdf[o] = 0.0
        o += c
    arr = dict(
        counts=counts.astype(np.int32), ridx=ridx, t=t, cdf=cdf,
        feats=rng.uniform(-1, 1, (cap, 3)).astype(np.float32),
        ties=(rng.integers(0, 8, cap) * 0.25).astype(np.float32),
        alpha=rng.uniform(0, 0.3, cap).astype(np.float32),
        tau=rng.uniform(0, 0.5, cap).astype(np.float32),
        pv=(rng.integers(-3, 4, N_PACKS) * 0.5).astype(np.float32),
        start=rng.uniform(0, 2, N_PACKS).astype(np.float32),
        step=rng.uniform(0.01, 0.05, N_PACKS).astype(np.float32),
        near=rng.uniform(0.2, 1.0, N_PACKS).astype(np.float32),
        far=rng.uniform(2.0, 4.0, N_PACKS).astype(np.float32),
        mats=rng.uniform(-1, 1, (N_PACKS, 2, 3)).astype(np.float32),
        u=rng.uniform(1e-8, 1 - 1e-8, cap).astype(np.float32),
        jitter=rng.uniform(0, 1, (N_PACKS, PACK_S)).astype(np.float32),
        dense_a=np.sort(rng.uniform(0, 4, (N_PACKS, PACK_S)), -1).astype(
            np.float32),
        dense_b=np.sort(rng.uniform(0, 4, (N_PACKS, 32)), -1).astype(
            np.float32),
        ids_a=np.sort(rng.choice(1 << 20, 200_000, replace=False)).astype(
            np.int32),
        ids_b=np.sort(rng.choice(1 << 20, 150_000, replace=False)).astype(
            np.int32))
    pad = np.iinfo(np.int32).max
    arr["ids_a"] = np.concatenate([arr["ids_a"], np.full(1000, pad,
                                                         np.int32)])
    arr["ids_b"] = np.concatenate([arr["ids_b"], np.full(500, pad,
                                                         np.int32)])
    return {k: torch.from_numpy(v).to(dev) for k, v in arr.items()}


def _pack_cases(P, R, a, dev):
    """(name, outputs) of every new pack_ops and raysample function on the
    inputs `a` (all on one device)."""
    import torch

    rid, n = a["ridx"], N_PACKS
    cap = rid.shape[0]
    seg_r = rid[::PACK_S][:2048]
    seg_in = a["near"][:2048]
    out = [
        ("counts_from_ridx", P.counts_from_ridx(rid, n)),
        ("ridx_from_counts", P.ridx_from_counts(a["counts"], cap)),
        ("offsets_from_counts", P.offsets_from_counts(a["counts"])),
        ("get_pack_infos_from_n", P.get_pack_infos_from_n(a["counts"])),
        ("get_pack_infos_from_first", P.get_pack_infos_from_first(
            P.offsets_from_counts(a["counts"]), cap)),
        ("get_pack_infos_from_boundary", P.get_pack_infos_from_boundary(
            P.mark_pack_boundaries(rid))),
        ("get_pack_infos_from_batch", P.get_pack_infos_from_batch(
            n, PACK_S, device=dev)),
        ("interleave_arange_simple", P.interleave_arange_simple(
            a["counts"], cap)),
        ("interleave_linstep", P.interleave_linstep(
            a["start"], a["counts"], a["step"], cap)),
        ("interleave_arange", P.interleave_arange(
            a["start"], a["start"] + a["step"] * a["counts"], a["step"],
            cap)),
        ("interleave_linspace", P.interleave_linspace(
            a["start"], a["start"] + 1.0, a["counts"], cap)),
        ("expand_pack_boundary", P.expand_pack_boundary(
            P.mark_pack_boundaries(rid)[:8192], 4)),
        ("octree_mark_consecutive_segments",
         P.octree_mark_consecutive_segments(
             (a["t"] * 4).to(torch.int32), rid)),
    ]
    for op in ("add", "sub", "mul", "div", "gt", "geq", "lt", "leq", "eq",
               "neq"):
        out.append((f"packed_{op}", getattr(P, f"packed_{op}")(
            a["ties"], a["pv"], rid)))
    out += [
        ("packed_mean", P.packed_mean(a["feats"], rid, n)),
        ("packed_max", P.packed_max(a["feats"], rid, n)),
        ("packed_min", P.packed_min(a["feats"], rid, n)),
        ("packed_cumsum", P.packed_cumsum(a["tau"], rid)),
        ("packed_cumsum exclusive", P.packed_cumsum(a["tau"], rid, True)),
        ("packed_diff", P.packed_diff(a["t"], rid, pack_last_fill=a["far"])),
        ("packed_backward_diff", P.packed_backward_diff(
            a["t"], rid, pack_first_fill=a["near"])),
        ("packed_sort", P.packed_sort(a["ties"], rid, torch.arange(
            cap, device=dev))),
        ("packed_sort_inplace", P.packed_sort_inplace(a["ties"], rid)),
        ("packed_searchsorted", P.packed_searchsorted(
            a["t"], rid, a["u"] * 4.0, rid, n)),
        ("packed_searchsorted_packed_vals",
         P.packed_searchsorted_packed_vals(a["t"], rid, a["t"], rid, n,
                                           side="left")),
        ("packed_invert_cdf", P.packed_invert_cdf(a["t"], a["cdf"], rid,
                                                  a["u"], rid, n)),
        ("packed_tau_to_vw", P.packed_tau_to_vw(a["tau"], rid)),
        ("packed_volume_render_compression",
         P.packed_volume_render_compression(a["alpha"], rid, n)),
        ("packed_to_dense", P.packed_to_dense(a["feats"], rid, n, PACK_S)),
        ("packed_matmul", P.packed_matmul(a["feats"], a["mats"], rid)),
        ("merge_two_batch", P.merge_two_batch(
            a["dense_a"], a["dense_a"], a["dense_b"], a["dense_b"])),
        ("merge_two_batch_a_includes_b", P.merge_two_batch_a_includes_b(
            a["dense_a"], torch.arange(n, dtype=torch.int32, device=dev),
            a["dense_b"][::2], torch.arange(0, n, 2, dtype=torch.int32,
                                            device=dev), n)),
        ("interleave_sample_step_wrt_depth_clamped",
         P.interleave_sample_step_wrt_depth_clamped(
             a["near"], a["far"], max_steps=PACK_S, dt_gamma=0.02,
             min_step_size=0.01, max_step_size=0.1,
             draw=lambda shape, lo, hi: a["jitter"])),
        ("interleave_sample_step_wrt_depth_in_packed_segments",
         P.interleave_sample_step_wrt_depth_in_packed_segments(
             a["near"], a["far"], seg_in, seg_in + 1.0, seg_r, n,
             steps_per_segment=PACK_S, dt_gamma=0.02, min_step_size=0.01,
             max_step_size=0.1, draw=lambda shape, lo, hi:
             a["jitter"][:2048])),
        ("intersect1d_unique", P.intersect1d_unique(a["ids_a"], a["ids_b"],
                                                    300_000)),
        ("batch_sample_step_wrt_depth", R.batch_sample_step_wrt_depth(
            a["near"], a["far"], PACK_S, u=a["jitter"])),
        ("batch_sample_step_wrt_sqrt_depth",
         R.batch_sample_step_wrt_sqrt_depth(a["near"], a["far"], PACK_S,
                                            u=a["jitter"])),
        ("packed_sample_cdf", R.packed_sample_cdf(a["t"], a["cdf"], rid, n,
                                                  24)),
    ]
    for name in ("merge_two_packs_sorted_aligned",
                 "try_merge_two_packs_sorted_aligned",
                 "merge_two_packs_sorted",
                 "merge_two_packs_sorted_a_includes_b"):
        out.append((name, getattr(P, name)(
            a["feats"][:, 0], a["ties"], rid, a["tau"], a["t"], rid, n)))
    return out


def _pack_maths_phase(dev, smi: str, paths: dict) -> None:
    """Every new pack_ops and raysample function at the F=4 bench render's
    buffer, card against CPU; transform round trips; the depth completion
    of a Waymo-sized map; dist_to_nn3_mean at path E's means."""
    import torch
    from nr3d_lib_tpu_torch.graphics import pack_ops as P
    from nr3d_lib_tpu_torch.graphics import raysample as R
    from nr3d_lib_tpu_torch.maths import transforms as TR
    from nr3d_lib_tpu_torch.maths.depth_completion import depth_completion
    from nr3d_lib_tpu_torch.maths.knn import dist_to_nn3_mean
    from nr3d_lib_tpu_torch.ops import _build

    a = _pack_inputs(dev)
    a_cpu = {k: v.cpu() for k, v in a.items()}
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    got = _pack_cases(P, R, a, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    want = _pack_cases(P, R, a_cpu, torch.device("cpu"))
    n_float = n_exact = 0
    worst = (0.0, "")
    for (name, g), (_, w) in zip(got, want):
        gs = g if isinstance(g, tuple) else (g,)
        ws = w if isinstance(w, tuple) else (w,)
        for i, (x, y) in enumerate(zip(gs, ws)):
            x = x.cpu()
            _require(x.shape == y.shape and x.dtype == y.dtype,
                     f"pack_maths: {name}[{i}] shape or dtype")
            if y.is_floating_point():
                # the infinities (an empty pack's max or min) exactly
                fin = torch.isfinite(y)
                _require(torch.equal(torch.isfinite(x), fin) and
                         torch.equal(x[~fin], y[~fin]),
                         f"pack_maths: {name}[{i}]'s infinities")
                e = float((x[fin] - y[fin]).abs().max()) / max(
                    float(y[fin].abs().max()), 1e-30) if fin.any() else 0.0
                worst = max(worst, (e, f"{name}[{i}]"))
                _require(e <= 1e-5, f"pack_maths: {name}[{i}] differs "
                         f"from the CPU route by {e:.3e} of its largest "
                         f"entry")
                n_float += 1
            else:
                _require(torch.equal(x, y), f"pack_maths: {name}[{i}] is "
                         f"not the CPU route's bit for bit")
                n_exact += 1
    sort_key, _, sort_pay = got[[n for n, _ in got].index("packed_sort")][1]
    ties = int((sort_key[1:] == sort_key[:-1]).sum())
    print(f"[pack_maths] {len(got)} functions at {N_PACKS} packs × {PACK_S} "
          f"slots ({int((a['counts'] == 0).sum())} empty packs, "
          f"{int((a['ridx'] == N_PACKS).sum())} padding slots) on {smi}: "
          f"{card_s:.2f} s on the card (first calls); {n_exact} integer, "
          f"boolean, index or order outputs bitwise the CPU route's "
          f"(packed_sort over {ties} tied neighbours); {n_float} float "
          f"outputs, the worst {worst[1]} at {worst[0]:.3e} of its largest "
          f"entry (tolerance 1e-5); launches {dict(_build.LAUNCHES)}")
    _require(not _build.LAUNCHES, "pack_maths launched a kernel of the port")
    del got, want, a, a_cpu

    # transforms: round trips on 2^20 rotations, and card against CPU
    rng = np.random.default_rng(43)
    q = rng.normal(size=(N_ROT, 4))
    q = torch.from_numpy((q / np.linalg.norm(q, axis=-1, keepdims=True)
                          ).astype(np.float32))
    aa = torch.from_numpy(rng.uniform(-1.5, 1.5, (N_ROT, 3)).astype(
        np.float32))
    # 6D vectors near rotations (a rotation's first two rows plus N(0,
    # 0.05) noise): two random 3-vectors can be near parallel, where
    # Gram–Schmidt divides by the small remainder and amplifies rounding
    q6 = rng.normal(size=(N_ROT, 4))
    q6 = torch.from_numpy((q6 / np.linalg.norm(q6, axis=-1, keepdims=True)
                           ).astype(np.float32))
    d6 = TR.matrix_to_rotation_6d(TR.quaternion_to_matrix(q6)) + \
        torch.from_numpy(rng.normal(0, 0.05, (N_ROT, 6)).astype(np.float32))
    res = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        qq, a3, r6 = q.to(where), aa.to(where), d6.to(where)
        m = TR.quaternion_to_matrix(qq)
        back = TR.matrix_to_quaternion(m)
        back = back * torch.sign(torch.sum(back * qq, -1, keepdim=True))
        m6 = TR.rotation_6d_to_matrix(r6)
        res[key] = dict(
            quat=back, aa=TR.matrix_to_axis_angle(TR.axis_angle_to_matrix(
                a3)), r6=TR.rotation_6d_to_matrix(
                    TR.matrix_to_rotation_6d(m6)), m6=m6,
            q_apply=TR.quaternion_apply(qq, a3))
    g, c = res["card"], res["cpu"]
    rt = {"quaternion": _err(g["quat"].cpu(), q),
          "axis-angle": _err(g["aa"].cpu(), aa),
          "6D": _err(g["r6"].cpu(), g["m6"].cpu())}
    vs = {k: _err(g[k].cpu(), c[k]) for k in g}
    print(f"[transforms] {N_ROT} rotations on {smi}: round trips, max "
          f"error " + ", ".join(f"{k} {e:.3e}" for k, e in rt.items()) +
          " (tolerance 1e-4); card against CPU, max " +
          ", ".join(f"{k} {e:.3e}" for k, e in vs.items()) +
          " (tolerance 1e-5)")
    _require(max(rt.values()) <= 1e-4, "a rotation round trip")
    _require(max(vs.values()) <= 1e-5, "transforms: card and CPU differ")
    del res, g, c

    # the depth completion of a Waymo front camera's map at 5%
    h, w = DEPTH_HW
    dmap = np.where(rng.uniform(size=(h, w)) < 0.05,
                    rng.uniform(1.0, 80.0, (h, w)), 0.0).astype(np.float32)
    dg = torch.from_numpy(dmap).to(dev)
    out_g = depth_completion(dg)
    ms = _time_ms(lambda: depth_completion(dg), iters=5, warmup=1)
    t0 = time.perf_counter()
    out_c = depth_completion(torch.from_numpy(dmap))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(out_g.cpu(), out_c)
    print(f"[depth_completion] {h} × {w} at 5% on {smi}: {ms:.3f} ms "
          f"device time (CPU route {cpu_ms:.1f} ms host); bitwise the CPU "
          f"route's: {same}; filled share "
          f"{float((out_g > 0).float().mean()):.4f}")
    _require(same, "depth_completion: card and CPU differ")

    # dist_to_nn3_mean at path E's 500,000 means
    means = torch.from_numpy(_gs_params(GS_N, seed=21)["means"]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    nn3 = dist_to_nn3_mean(means, chunk=KNN_CHUNK)
    ev[1].record()
    torch.cuda.synchronize()
    knn_ms = ev[0].elapsed_time(ev[1])
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    pts = means.cpu().double()
    rows = torch.from_numpy(np.random.default_rng(44).choice(
        GS_N, N_KNN_CHECK, replace=False))
    brute = []
    for s in range(0, N_KNN_CHECK, 256):
        d2 = torch.cdist(pts[rows[s:s + 256]], pts) ** 2
        brute.append(torch.topk(d2, 4, largest=False).values[:, 1:].mean(
            -1))
    brute = torch.cat(brute)
    rel = float(((nn3.cpu()[rows].double() - brute).abs() /
                 brute.clamp(min=1e-30)).max())
    print(f"[dist_to_nn3_mean] {GS_N} means (path E's scene) on {smi}: "
          f"{knn_ms:.3f} ms (CUDA events), chunk {KNN_CHUNK} rows (a "
          f"[{KNN_CHUNK}, {GS_N}] distance block of "
          f"{KNN_CHUNK * GS_N * 4 / 1e9:.1f} GB; the default 8192 would be "
          f"{8192 * GS_N * 4 / 1e9:.1f} GB), peak memory {peak:.1f} MiB; "
          f"{N_KNN_CHECK} rows against a float64 brute force: max relative "
          f"{rel:.3e} (tolerance 1e-5)")
    _require(rel <= 1e-5, "dist_to_nn3_mean disagrees with the brute force")
    paths["pack_maths"] = ({}, 1)


def _a14_paths(dev, smi: str, paths: dict):
    """The ray, pack and maths layers (A14) where they meet the kernels:
    DMTet over the --w4 object SDF, pose refinement through its render,
    and the new pack_ops, raysample and maths functions at the render's
    buffer sizes. Returns the --w4 model and its CPU twin (A15 reuses
    them)."""
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    w4 = _pretrained(LoTDNeuSModel, OBJ_W4_CFG, dev, "neus_obj_w4_a14")
    cpu = _cpu_twin(w4, LoTDNeuSModel, OBJ_W4_CFG)
    _dmtet_phase(w4, cpu, smi, paths)
    _pose_phase(w4, cpu, smi, paths)
    _pack_maths_phase(dev, smi, paths)
    return w4, cpu


# ---------------------------------------------------------------- A15
DDP_RANKS = 2
DDP_STEPS = 3             # timed, after one warm-up step
DDP_DRAW_SEED = 9         # + rank: a rank's sampling draws
DDP_LC_SEED = 1000        # the occupancy updates' draws, the same on all ranks
DDP_JOIN_S = 300.0
ZOO_CPU_RAYS = 512
CHUNK = 524_288
VIEWER_HW = (256, 256)
VIEWER_CPU_ROWS = 16      # the CPU route's share of the viewer's frame
PROFILE_WARMUP, PROFILE_FRAMES = 2, 5


def _ddp_model(dev):
    """The production F=4 step's model as `main` seeds it (weights seed 1,
    the seeded 15% occupancy)."""
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    m = LoTDNeuSModel(**PROD_CFG, seed=0, device=dev)
    _seed_weights(m, m.field.implicit_surface.encoding, 1)
    m.populate()
    _seed_occupancy(m)
    return m


def _ddp_rank(rank: int, world: int, work: str, device: str) -> None:
    """One rank of `ddp_w4_train_4096`, started by `spawn`: a gloo group
    whose ranks share cuda:0 (joined through a file in `work`, 60 s
    timeout), the production step on this rank's 2048 of the 4096 rays
    through `parallel.train.make_sharded_train_step` (its own draws; the
    occupancy updates' draws the same on every rank): one warm-up step,
    DDP_STEPS timed, one counted by the profiler (the compared steps,
    before the first occupancy update, each step's mean gradients kept);
    then two more under `_profile` and on through the first occupancy
    update (the ranks compared with each other). Writes
    `work/rank<r>.pt`."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nr3d_lib_tpu_torch.ops import _build
    from nr3d_lib_tpu_torch.parallel import make_mesh
    from nr3d_lib_tpu_torch.parallel.train import (make_sharded_train_step,
                                                   shard_rays)

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "init"),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh([world, 1])
        model = _ddp_model(dev)
        o, d = (torch.from_numpy(a).to(dev) for a in _rays(N_RAYS, seed=0))
        batch = shard_rays({"o": o, "d": d}, mesh)
        opt = torch.optim.Adam(model.parameters(), lr=5e-3)
        gen = torch.Generator(dev).manual_seed(DDP_DRAW_SEED + rank)
        gen_lc = torch.Generator(dev).manual_seed(DDP_LC_SEED)
        step = make_sharded_train_step(
            lambda b, g: _step_loss(model, b["o"], b["d"], generator=g), opt,
            mesh)
        its = iter(range(1, 10 ** 6))
        losses, grads = [], []

        def one():
            it = next(its)
            model.training_before_per_step(it, gen_lc)
            losses.append(step(batch, gen))
            if it <= DDP_STEPS + 2:     # the compared steps (on the card)
                grads.append({k: p.grad.detach().clone() for k, p in
                              model.named_parameters()
                              if p.grad is not None})
            return it

        one()
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        times = []
        for _ in range(DDP_STEPS):
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.LAUNCHES)
        counts = _device_kernel_counts(one)
        out = {"rays": int(batch["o"].shape[0]),
               "losses": [float(v) for v in losses],
               "grads": [{k: g.cpu() for k, g in gs.items()}
                         for gs in grads],
               "params": {k: p.detach().cpu().clone() for k, p in
                          model.named_parameters()},
               "occ": model.accel.occ.val_grid.cpu().clone(),
               "times": times,
               "launches": launches, "counts": counts,
               "mesh": str(mesh), "backend": dist.get_backend()}
        # after the compared steps: two more under the profiler, each
        # rank its own (both take part in every all-reduce), then on to
        # the first occupancy update
        _profile(one, statistics.median(times),
                 f"ddp_w4_train_4096 rank {rank} step")
        occ = model.accel.occ.val_grid.clone()
        while one() < model.lifecycle_update_every:
            pass
        out["updated"] = not torch.equal(occ, model.accel.occ.val_grid)
        out["occ_after_update"] = model.accel.occ.val_grid.cpu()
        out["params_after_update"] = {k: p.detach().cpu() for k, p in
                                      model.named_parameters()}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def _loss_parts(model, o, d, generator):
    """`_step_loss`'s MSE, and its eikonal term's sum and count."""
    import torch

    rendered, vb = model.ray_query(_tested(model, o, d), generator=generator)
    mse = torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2)
    valid = (vb["ridx"] < o.shape[0]).float()
    e = (torch.linalg.norm(vb["nablas_packed"], dim=-1) - 1.0) ** 2
    return float(mse), float((e * valid).sum()), float(valid.sum())


def _ddp_reference(dev, forced):
    """One process on the two ranks' halves, with their draws
    (`tests/torch_parallel_ranks.halves_reference`, the tier-1 tests'
    reference), the lifecycle once a step, Adam stepping on the ranks'
    gradients `forced`. Returns (losses, each step's gradients,
    parameters, step 1's loss over the union of the halves' samples)."""
    import torch

    sys.path.insert(0, str(REPO / "tests"))
    from torch_parallel_ranks import halves_reference

    model = _ddp_model(dev)
    o, d = (torch.from_numpy(a).to(dev) for a in _rays(N_RAYS, seed=0))
    k = N_RAYS // DDP_RANKS
    gen_lc = torch.Generator(dev).manual_seed(DDP_LC_SEED)
    union = []

    def before_step(it):
        model.training_before_per_step(it, gen_lc)
        if it == 1:
            # the same samples as step 1's (fresh generators, same seeds):
            # the eikonal term over the union, against the halves' mean
            with torch.no_grad():
                parts = [_loss_parts(model, o[r * k:(r + 1) * k],
                                     d[r * k:(r + 1) * k], torch.Generator(
                                         dev).manual_seed(DDP_DRAW_SEED + r))
                         for r in range(DDP_RANKS)]
            union.append(sum(p[0] for p in parts) / DDP_RANKS + 0.1 *
                         sum(p[1] for p in parts) / sum(p[2] for p in parts))

    losses, grads, params = halves_reference(
        model, lambda oh, dh, g: _step_loss(model, oh, dh, generator=g),
        o, d, [DDP_DRAW_SEED + r for r in range(DDP_RANKS)], DDP_STEPS + 2,
        before_step=before_step, forced=forced)
    return losses, grads, params, union[0]


def _rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _ddp_phase(dev, smi: str, paths: dict) -> None:
    """ddp_w4_train_4096: two gloo ranks on cuda:0 against one process on
    the same halves; then the step in an NCCL group of world size 1
    against a plain step."""
    import datetime
    import multiprocessing as mp
    import tempfile

    import torch
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as work:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_ddp_rank,
                             args=(r, DDP_RANKS, work, str(dev)))
                 for r in range(DDP_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = t0 + DDP_JOIN_S
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in procs]
        _require(not hung and codes == [0] * DDP_RANKS,
                 f"ddp_w4_train_4096: rank exit codes {codes}")
        wall = time.perf_counter() - t0
        outs = [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(DDP_RANKS)]
    # the reference steps on rank 0's gradients: B2's atomics differ in
    # the last bits from run to run, and the render's discrete choices
    # would turn that into other samples a few steps on
    ref_losses, ref_grads, ref_params, union = _ddp_reference(
        dev, outs[0]["grads"])
    # the step's nablas are split (B3 forward, B4 backward), so B1 runs
    # without its corner words: no brick4_fwd_g (PERF.md §6, B1 want_g)
    names = ("brick4_fwd", "brick4_bwd", "brick4_dydx", "brick4_bwd2",
             "occ_march_budget")
    for r, out in enumerate(outs):
        med = statistics.median(out["times"])
        print(f"[ddp_w4_train_4096] rank {r} of {DDP_RANKS} (gloo, cuda:0, "
              f"{out['mesh']}): {out['rays']} rays, {DDP_STEPS} steps: "
              f"median {med:.3f} ms/step (min {min(out['times']):.3f}, max "
              f"{max(out['times']):.3f}) on {smi}; launches in the timed "
              f"steps {out['launches']}; losses "
              f"{' '.join(f'{v:.7f}' for v in out['losses'])}")
        _require(out["rays"] == N_RAYS // DDP_RANKS, "a rank's rays")
        for n in names:
            _require(out["launches"].get(n, 0) >= DDP_STEPS,
                     f"ddp rank {r}: {n} launched "
                     f"{out['launches'].get(n, 0)} times in {DDP_STEPS} "
                     "steps")
    print(f"[ddp_w4_train_4096] rank 0's profiled step: {outs[0]['counts']}; "
          f"the group's run {wall:.1f} s of wall time (spawn, model, "
          f"steps)")
    _require(all(outs[0]["counts"].get(k, 0) >= 1 for k in (
        "brick4_fwd_kernel", "brick4_bwd_kernel", "brick4_dydx_kernel",
        "brick4_bwd2_kernel")) and any(k.startswith("occ_march_budget")
                                       for k in outs[0]["counts"]),
        "ddp: the profiled step misses a kernel")
    g_errs = [max(_rel(got[k], g) for k, g in want.items())
              for got, want in zip(outs[0]["grads"], ref_grads)]
    l_err = [abs(a - b) / abs(b) for a, b in zip(outs[0]["losses"],
                                                 ref_losses)]
    p_err = max(_rel(outs[0]["params"][k], p) for k, p in ref_params.items())
    print(f"[ddp_w4_train_4096] against one process on the two halves, "
          f"Adam stepping on the ranks' gradients: each step's gradients "
          f"{max(g_errs):.3e} relative L2 (largest over the parameters and "
          f"the {len(g_errs)} steps, step 1 {g_errs[0]:.3e}; tolerance "
          f"1e-5), the losses {max(l_err):.3e} relative (step 1 "
          f"{l_err[0]:.3e}; tolerance 1e-6), the parameters after {len(ref_losses)} steps "
          f"{p_err:.3e} (tolerance 1e-4); the mean of the halves' losses "
          f"(the eikonal term is a mean over each half's samples); the "
          f"steps stop before the occupancy update, whose threshold turns "
          f"the atomics' last bits into flipped cells")
    print(f"[ddp_w4_train_4096] step 1's loss as the mean of the ranks' "
          f"losses {ref_losses[0]:.7f}, over the union of their samples "
          f"{union:.7f}: {abs(ref_losses[0] - union) / abs(union):.3e} "
          f"relative (the eikonal term weighs each rank's samples by its "
          f"own count)")
    _require(len(g_errs) == len(ref_losses) and
             all(set(a) == set(b) for a, b in zip(outs[0]["grads"],
                                                  ref_grads))
             and max(g_errs) <= 1e-5, "ddp: the steps' gradients")
    _require(max(l_err) <= 1e-6, "ddp: the losses")
    _require(p_err <= 1e-4, "ddp: the parameters")
    same = all(torch.equal(outs[0][p][k], outs[1][p][k])
               for p in ("params", "params_after_update")
               for k in outs[0][p]) and \
        torch.equal(outs[0]["occ"], outs[1]["occ"]) and \
        torch.equal(outs[0]["occ_after_update"], outs[1]["occ_after_update"])
    print(f"[ddp_w4_train_4096] the ranks' parameters and occupancy grids "
          f"the same bits after the compared steps and after the first "
          f"occupancy update (it = 16; it changed the grid: "
          f"{outs[0]['updated']}): {same}")
    _require(same and outs[0]["updated"], "ddp: the ranks diverged")
    paths["ddp_w4_train_4096 rank 0"] = (outs[0]["launches"], DDP_STEPS)

    # ---- NCCL at world size 1, against a plain step
    from nr3d_lib_tpu_torch.parallel import make_mesh
    from nr3d_lib_tpu_torch.parallel.train import make_sharded_train_step

    with tempfile.TemporaryDirectory() as work:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(work, "init"),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            mesh = make_mesh([1, 1])
            o, d = (torch.from_numpy(a).to(dev) for a in _rays(N_RAYS, 0))
            models = [_ddp_model(dev) for _ in range(2)]
            gens = [torch.Generator(dev).manual_seed(DDP_DRAW_SEED)
                    for _ in range(2)]
            m, plain = models
            opt = torch.optim.Adam(m.parameters(), lr=5e-3)
            step = make_sharded_train_step(
                lambda b, g: _step_loss(m, b["o"], b["d"], generator=g), opt,
                mesh)
            loss = step({"o": o, "d": d}, gens[0])
            ref = _step_loss(plain, o, d, generator=gens[1])
            ref.backward()
            ref = ref.detach()
            err = max(_rel(p.grad, q.grad) for p, q in
                      zip(m.parameters(), plain.parameters())
                      if q.grad is not None)
            backend = dist.get_backend(mesh.get_group("data"))
        finally:
            dist.destroy_process_group()
    print(f"[ddp_w4_train_4096 nccl] world size 1 ({backend}; the step "
          f"runs no collective in a group of one): loss "
          f"{float(loss):.7f} vs the plain step's {float(ref):.7f}; step 1's "
          f"gradients {err:.3e} relative L2 (tolerance 1e-5: B2's atomics "
          f"sum in launch order)")
    _require(backend == "nccl" and err <= 1e-5 and
             float(loss) == float(ref), "ddp nccl: the step")


def _zoo_rays(model, n: int, dev):
    """Rays and per-ray inputs for a config's model family (the example
    trainers' distributions)."""
    import torch

    name = type(model).__name__
    if "Forest" in name:
        o, d = _street_rays(n, seed=40)
        extra = {}
    elif name == "EmerNeRFModel":
        o, d, ts = _scene_rays(n, seed=41)
        extra = {"ts": ts}
    elif "Generative" in name:
        o, d, bidx, ts = _shape_rays(n, seed=42)
        extra = {"bidx": bidx}
    else:
        o, d = _rays(n, seed=43)
        extra = {"ts": np.random.default_rng(44).uniform(
            -1.0, 1.0, n).astype(np.float32)} if "Dynamic" in name else {}
    on = lambda a: torch.from_numpy(a).to(dev)
    return on(o), on(d), {k: on(v) for k, v in extra.items()}


def _zoo_loss(model, o, d, extra, generator):
    """MSE(rgb, |d|), plus 0.1·the eikonal mean over the query's nablas
    for an SDF family."""
    import torch

    rendered, vb = model.ray_query(_tested(model, o, d, extra),
                                   generator=generator)
    loss = torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2)
    nablas = vb.get("nablas_packed", vb.get("nablas"))
    if nablas is not None:
        loss = loss + 0.1 * torch.mean(
            (torch.linalg.norm(nablas, dim=-1) - 1.0) ** 2)
    return loss


def _config_zoo(dev, smi: str, paths: dict) -> None:
    """Each example config through the port's `load_config` and
    `instantiate(cfg.model, seed=cfg.seed, device="cuda")`: a render of
    `training.rays_per_batch` rays, its first ZOO_CPU_RAYS against the CPU
    route of the same state, one Adam step at `training.lr`."""
    import torch
    from nr3d_lib_tpu_torch.config import instantiate, load_config
    from nr3d_lib_tpu_torch.ops import _build

    union = set()
    for path in sorted((REPO / "examples" / "configs").glob("[!_]*.yaml")):
        cfg = load_config(path)
        n = int(cfg.training.rays_per_batch)
        model = instantiate(cfg.model, seed=int(cfg.seed), device=dev)
        model.populate()
        cpu = instantiate(cfg.model, seed=int(cfg.seed), device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             model.state_dict().items()})
        o, d, extra = _zoo_rays(model, n, dev)
        def render():
            return model.ray_query(_tested(model, o, d, extra))

        with torch.no_grad():
            render()                                           # warm-up
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            rendered, _ = render()
            torch.cuda.synchronize()
            render_ms = (time.perf_counter() - t0) * 1e3
            render_launches = dict(_build.LAUNCHES)
            _profile(render, render_ms, f"config_zoo {path.stem} render")
            k = ZOO_CPU_RAYS
            r_cpu, _ = cpu.ray_query(_tested(
                cpu, o[:k].cpu(), d[:k].cpu(),
                {a: v[:k].cpu() for a, v in extra.items()}))
        err = (rendered["rgb_volume"][:k].cpu() - r_cpu["rgb_volume"]) \
            .abs().reshape(k, -1).amax(-1)
        share = float((err <= 1e-4).float().mean())
        opt = torch.optim.Adam(model.parameters(), lr=float(cfg.training.lr))
        gen = torch.Generator(dev).manual_seed(int(cfg.seed))
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        loss = _zoo_loss(model, o, d, extra, gen)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        loss = loss.detach()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        step_launches = dict(_build.LAUNCHES)
        finite = all(bool(torch.isfinite(v).all()) for v in rendered.values())
        label = f"config_zoo {path.stem}"
        print(f"[{label}] {type(model).__module__}.{type(model).__name__}, "
              f"{sum(p.numel() for p in model.parameters())} parameters; "
              f"{n} rays on {smi}: render {render_ms:.3f} ms "
              f"(launches {render_launches}), Adam({cfg.training.lr}) step "
              f"{step_ms:.3f} ms (launches {step_launches}), loss "
              f"{float(loss):.6f}; {share * 100:.2f}% of {k} rays within "
              f"1e-4 of the CPU route in rgb (max {float(err.max()):.3e})")
        _require(type(model).__module__.startswith("nr3d_lib_tpu_torch."),
                 f"{label}: not the port's class")
        _require(finite and bool(torch.isfinite(loss)), f"{label}: not "
                 "finite")
        _require(share >= 0.99, f"{label}: the card and the CPU disagree")
        both = dict(render_launches)
        for key, v in step_launches.items():
            both[key] = both.get(key, 0) + v
        paths[label] = (both, 1)
        union |= set(both)
        del model, cpu, opt
    want = {"brick4_fwd", "brick4_bwd", "gather1d", "brick_fwd", "brick_bwd",
            "brick_fwd_b", "brick_dydx_b", "brick_bwd_b", "brick_bwd2_b",
            "permuto4_fwd", "permuto4_bwd", "permuto4_dydx"}
    print(f"[config_zoo] kernels launched over the eight configs: "
          f"{sorted(union)}; expected among them: {sorted(want)}")
    _require(want <= union, f"config_zoo: missing {sorted(want - union)}")


def _chunked_phase(w4, smi: str, paths: dict) -> None:
    """`loop_chunks` over B1 and `scan_chunks` over B2 at the DMTet grid's
    2,097,152 vertices of the --w4 object SDF, CHUNK points a chunk,
    against one call each."""
    import torch
    from nr3d_lib_tpu_torch.models.tetrahedral import DMTet
    from nr3d_lib_tpu_torch.ops import _build
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4
    from nr3d_lib_tpu_torch.ops.chunking import loop_chunks, scan_chunks

    dev = next(w4.parameters()).device
    enc = w4.field.implicit_surface.encoding
    meta = enc.meta
    with torch.no_grad():
        table = enc._build_table()
        x = DMTet(resolution=DMTET_RES, device=dev).base_verts * 0.5 + 0.5
        n = x.shape[0]
        g = torch.from_numpy(np.random.default_rng(45).normal(
            size=(n, 4 * len(meta.levels))).astype(np.float32)).to(dev)

        def fwd_one():
            return B4.brick4_encode(x, table, meta)

        def fwd_chunks():
            return loop_chunks(lambda xc: ((B4.brick4_encode(
                xc, table, meta),), ()), (x,), n, CHUNK)[0][0]

        def bwd_one():
            return B4._bwd_cuda(x, g, meta, need_dx=False)[1]

        def bwd_chunks():
            return scan_chunks(lambda xc, gc: ((), (B4._bwd_cuda(
                xc, gc, meta, need_dx=False)[1],)), (x, g), n, CHUNK,
                (torch.zeros((meta.total_rows, 2 * B4.LANES), device=dev),)
            )[1][0]

        results = {}
        for name, fn in (("fwd_one", fwd_one), ("fwd_chunks", fwd_chunks),
                         ("bwd_one", bwd_one), ("bwd_chunks", bwd_chunks)):
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            results[name] = (fn(), dict(_build.LAUNCHES))
            torch.cuda.synchronize()
        times = {name: _time_ms(fn, iters=5, warmup=1) for name, fn in (
            ("fwd_one", fwd_one), ("fwd_chunks", fwd_chunks),
            ("bwd_one", bwd_one), ("bwd_chunks", bwd_chunks))}
    same = torch.equal(results["fwd_one"][0], results["fwd_chunks"][0])
    rel = _rel(results["bwd_chunks"][0], results["bwd_one"][0])
    print(f"[chunked_w4] {n} points, chunks of {CHUNK}, on {smi}: "
          f"loop_chunks over B1 {times['fwd_chunks']:.3f} ms vs one call "
          f"{times['fwd_one']:.3f} ms, the same bits: {same}, launches "
          f"{results['fwd_chunks'][1]} vs {results['fwd_one'][1]}; "
          f"scan_chunks over B2 {times['bwd_chunks']:.3f} ms vs one call "
          f"{times['bwd_one']:.3f} ms, dL/dtable {rel:.3e} relative L2 "
          f"(tolerance 1e-6: B2's atomics sum in launch order), launches "
          f"{results['bwd_chunks'][1]} vs {results['bwd_one'][1]}")
    _require(same and results["fwd_chunks"][1] == {"brick4_fwd": 4} and
             results["fwd_one"][1] == {"brick4_fwd": 1},
             "chunked_w4: loop_chunks over B1")
    _require(rel <= 1e-6 and results["bwd_chunks"][1] == {"brick4_bwd": 4}
             and results["bwd_one"][1] == {"brick4_bwd": 1},
             "chunked_w4: scan_chunks over B2")
    paths["chunked_w4 loop_chunks"] = (results["fwd_chunks"][1], 1)
    paths["chunked_w4 scan_chunks"] = (results["bwd_chunks"][1], 1)


def _viewer_phase(w4, cpu, smi: str, paths: dict) -> None:
    """`InteractiveViewer` over the --w4 object model at VIEWER_HW: every
    layer's `frame_png` read back by the port's PNG reader against the
    viewer's mapping of `NeuralRenderer`'s render at the same camera, bit
    for bit; the occupancy and AABB layers drawn over it; the depth's
    colours on the card against the CPU route's (on the middle
    VIEWER_CPU_ROWS rows)."""
    import torch
    from nr3d_lib_tpu_torch import viewer as V
    from nr3d_lib_tpu_torch.graphics.cameras import pinhole_get_rays
    from nr3d_lib_tpu_torch.gui import NeuralRenderer
    from nr3d_lib_tpu_torch.gui_datalayers import (aabb_datalayer,
                                                   draw_datalayers,
                                                   occgrid_datalayer)
    from nr3d_lib_tpu_torch.ops import _build
    from nr3d_lib_tpu_torch.plot import color_depth
    from nr3d_lib_tpu_torch.utils import decode_png, img_to_uint8

    cpu.load_state_dict({k: v.cpu() for k, v in w4.state_dict().items()})
    layers = [occgrid_datalayer(w4.accel), aabb_datalayer(w4.space.aabb)]
    v = V.InteractiveViewer(w4, hw=VIEWER_HW, overlays=layers)
    cam = (0.6, 0.35, 2.5)
    names = v.layers()
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    png = v.frame_png(*cam, names[0])
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    _profile(lambda: v.frame_png(*cam, names[0]), frame_ms, "viewer frame")
    c2w = v.camera(*cam)
    images = NeuralRenderer(w4, VIEWER_HW).render(c2w)
    bad = []
    for name in names:
        got = decode_png(v.frame_png(*cam, name))
        if not np.array_equal(got, V._to_uint8_layer(images[name])):
            bad.append(name)
    rgb = decode_png(png)
    same_rgb = np.array_equal(rgb, img_to_uint8(images["rgb_volume"]))
    over = decode_png(v.frame_png(*cam, names[0], overlay=True))
    want_over = draw_datalayers(rgb, layers, v._renderer.intr, c2w)
    painted = int((over != rgb).any(-1).sum())
    depth = torch.from_numpy(images["depth_volume"]).to(
        next(w4.parameters()).device)
    scale = float(depth.max())
    cd_card = color_depth(depth, scale)
    cd_same = np.array_equal(cd_card, color_depth(depth.cpu().numpy(),
                                                  scale))
    # the CPU route on the frame's middle VIEWER_CPU_ROWS rows
    h, w = VIEWER_HW
    r0 = (h - VIEWER_CPU_ROWS) // 2
    rows = slice(r0 * w, (r0 + VIEWER_CPU_ROWS) * w)
    cpu_r = NeuralRenderer(cpu, VIEWER_HW)
    o, d = pinhole_get_rays(cpu_r.uv[rows], cpu_r.intr,
                            torch.from_numpy(c2w))
    with torch.no_grad():
        r_cpu, _ = cpu.ray_query(cpu.ray_test(o, d))
    cpu_depth = r_cpu["depth_volume"].reshape(VIEWER_CPU_ROWS, w)
    cd_cpu = color_depth(cpu_depth, scale)
    agree = float((cd_card[r0:r0 + VIEWER_CPU_ROWS] == cd_cpu).all(-1)
                  .mean())
    print(f"[viewer_w4] {VIEWER_HW[0]}x{VIEWER_HW[1]} on {smi}: layers "
          f"{list(names)}; frame_png {frame_ms:.1f} ms (render, PNG "
          f"encode), launches {launches}; every layer's PNG the bits of its "
          f"render: {not bad} {bad}; rgb = img_to_uint8: {same_rgb}; the "
          f"occupancy ({len(layers[0]['edges'])} edges) and AABB layers "
          f"paint {painted} pixels, as draw_datalayers: "
          f"{np.array_equal(over, want_over)}; color_depth on the card's "
          f"depth the bits of its CPU copy: {cd_same}, and {agree * 100:.2f}"
          f"% of the middle {VIEWER_CPU_ROWS} rows' pixels the colours of "
          f"the CPU route's render")
    _require(not bad and same_rgb, "viewer_w4: a frame is not its render")
    _require(np.array_equal(over, want_over) and painted > 0,
             "viewer_w4: the overlays")
    _require(cd_same and agree >= 0.99, "viewer_w4: color_depth")
    _require(all(launches.get(k, 0) >= 1 for k in (
        "brick4_fwd", "brick4_dydx", "gather1d")), "viewer_w4: launches")
    paths["viewer_w4"] = (launches, 1)


def _profile_ckpt_phase(dev, smi: str, paths: dict) -> None:
    """`Profiler(warmup=2, record_frames=5, sync=True)` around the
    production step's stages, then `save_sharded`/`load_sharded` of the
    model's and Adam's state on the card, the next step from both."""
    import tempfile

    import torch
    from nr3d_lib_tpu_torch.checkpoint_sharded import (abstract_like,
                                                       load_sharded,
                                                       save_sharded)
    from nr3d_lib_tpu_torch.profile import Profiler

    model = _ddp_model(dev)
    o, d = (torch.from_numpy(a).to(dev) for a in _rays(N_RAYS, seed=0))
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    gen = torch.Generator(dev).manual_seed(9)
    prof = Profiler(warmup=PROFILE_WARMUP, record_frames=PROFILE_FRAMES,
                    sync=True)
    for it in range(1, PROFILE_WARMUP + PROFILE_FRAMES + 1):
        with prof.scope("step"):
            with prof.scope("lifecycle"):
                model.training_before_per_step(it, gen)
            with prof.scope("forward"):
                loss = _step_loss(model, o, d, generator=gen)
            with prof.scope("backward"):
                opt.zero_grad(set_to_none=True)
                loss.backward()
            with prof.scope("optimizer"):
                opt.step()
        prof.step_frame()
    step = prof.root.children["step"]
    step_ms = step.total / step.count * 1e3
    print(f"[profile_ckpt] Profiler(warmup={PROFILE_WARMUP}, record_frames="
          f"{PROFILE_FRAMES}, sync=True) over the production step on {smi}:")
    for line in prof.report().splitlines():
        print(f"[profile_ckpt]   {line}")
    nodes = [step] + list(step.children.values())
    _profile(lambda: _step_loss(model, o, d, generator=gen).backward(),
             step_ms, "profile_ckpt forward and backward")
    _require(set(step.children) == {"lifecycle", "forward", "backward",
                                    "optimizer"} and
             all(nd.count == PROFILE_FRAMES for nd in nodes) and
             sum(c.total for c in step.children.values()) <= step.total,
             "profile_ckpt: the profiler's tree")

    state = {"model": model.state_dict(), "opt": opt.state_dict()}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        path = save_sharded(os.path.join(work, "ckpt"), state)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        back = load_sharded(path, abstract_like(state))
        load_s = time.perf_counter() - t0
    twin = _ddp_model(dev)
    twin.load_state_dict(back["model"])
    twin_opt = torch.optim.Adam(twin.parameters(), lr=5e-3)
    twin_opt.load_state_dict(back["opt"])
    same_state = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), twin.state_dict().values()))
    # the next step: the loaded model's loss, and both optimizers fed the
    # live step's gradients (B2's atomics make two backwards differ)
    gens = [torch.Generator(dev).manual_seed(77) for _ in range(2)]
    losses = []
    for m, g in ((model, gens[0]), (twin, gens[1])):
        m.training_before_per_step(PROFILE_WARMUP + PROFILE_FRAMES + 1, g)
    for m, g in ((model, gens[0]), (twin, gens[1])):
        losses.append(_step_loss(m, o, d, generator=g))
    opt.zero_grad(set_to_none=True)
    losses[0].backward()
    for p, q in zip(model.parameters(), twin.parameters()):
        q.grad = None if p.grad is None else p.grad.clone()
    opt.step()
    twin_opt.step()
    same_step = losses[0].item() == losses[1].item() and all(
        torch.equal(p, q) for p, q in zip(model.parameters(),
                                          twin.parameters()))
    same_adam = all(torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]) for a, b in
                    zip(opt.state_dict()["state"].values(),
                        twin_opt.state_dict()["state"].values()))
    print(f"[profile_ckpt] save_sharded {size / 2 ** 20:.1f} MiB (model and "
          f"Adam state) in {save_s:.2f} s, load_sharded {load_s:.2f} s on "
          f"{smi}; the loaded state the same bits: {same_state}; the next "
          f"step's loss {losses[0].item():.7f} from both, parameters and "
          f"Adam's moments after it the same bits: {same_step and same_adam}")
    _require(same_state and same_step and same_adam,
             "profile_ckpt: the checkpoint round trip")


def _a15_paths(dev, smi: str, paths: dict, w4, cpu) -> None:
    """Infra and multi-GPU (A15): the data-parallel production step, the
    eight example configs through `instantiate`, chunked kernels, the
    viewer, the profiler and the sharded checkpoint."""
    t0 = time.perf_counter()
    _ddp_phase(dev, smi, paths)
    t1 = time.perf_counter()
    _config_zoo(dev, smi, paths)
    t2 = time.perf_counter()
    _chunked_phase(w4, smi, paths)
    _viewer_phase(w4, cpu, smi, paths)
    t3 = time.perf_counter()
    _profile_ckpt_phase(dev, smi, paths)
    print(f"[time] A15: ddp {t1 - t0:.1f} s, config_zoo {t2 - t1:.1f} s, "
          f"chunked and viewer {t3 - t2:.1f} s, profile_ckpt "
          f"{time.perf_counter() - t3:.1f} s on {smi}")


def _field_phase_classic(o, d, dev, paths: dict, smi: str) -> None:
    """`PermutoSDF` and `PermutoNeRF` at the JAX defaults, the classic
    lattice (res [8 … 128], 2^17 entries a level), on the field phase's
    393,216 points: the autograd nablas, an eikonal step through their
    second order, a density step; each timed, with its peak memory, and
    held against the CPU port on the first N_FIELD_CPU points. No kernel
    of the port launches."""
    import torch
    from nr3d_lib_tpu_torch.models.fields.nerf import PermutoNeRF
    from nr3d_lib_tpu_torch.models.fields.sdf import PermutoSDF
    from nr3d_lib_tpu_torch.ops import _build

    x = _ray_points(o, d, 96, seed=29) * 2.0 - 1.0
    n = x.shape[0]
    xc = x[:N_FIELD_CPU].cpu()
    pairs = []
    for cls, seed in ((PermutoSDF, 30), (PermutoNeRF, 31)):
        f = cls(seed=0, device=dev)
        _require(f.bank.backend == "xla", "the default bank is not classic")
        p = f.bank.flattened_params
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.random.default_rng(seed).uniform(
                -0.1, 0.1, tuple(p.shape)).astype(np.float32)))
        fc = cls(seed=0, device="cpu")
        fc.load_state_dict({k: v.cpu() for k, v in f.state_dict().items()})
        pairs.append((f, fc))
    (sdf, sdf_cpu), (nerf, nerf_cpu) = pairs
    meta = sdf.bank.meta
    print(f"[field classic] PermutoSDF / PermutoNeRF, the classic lattice: "
          f"{meta.n_levels} levels of {meta.hashmap_sizes[0]} entries, "
          f"{n} points, on {smi}")

    def eik_loss(m, xx):
        out = m.forward_sdf_nablas(xx)
        nrm = torch.linalg.norm(out["nablas"], dim=-1)
        return torch.mean(out["sdf"] ** 2) + 0.1 * torch.mean((nrm - 1.0) ** 2)

    def nerf_loss(m, xx):
        out = m.forward_density(xx)
        return torch.mean(out["sigma"]) + torch.mean(out["h"] ** 2)

    def step(m, fn, xx):
        m.zero_grad(set_to_none=True)
        fn(m, xx).backward()

    def grads_vs_cpu(m, mc, fn, what):
        step(m, fn, x[:N_FIELD_CPU])
        step(mc, fn, xc)
        errs = {k: float(torch.linalg.norm(a.grad.cpu() - b.grad) /
                         max(float(torch.linalg.norm(b.grad)), 1e-12))
                for (k, a), b in zip(m.named_parameters(), mc.parameters())
                if b.grad is not None}
        _require("bank.flattened_params" in errs, f"{what}: no table grad")
        print(f"[{what}] {N_FIELD_CPU} points: gradients vs the CPU port, "
              f"relative L2 per tensor (tolerance 1e-3: the table's "
              f"gradient sums by atomics on the card): " + ", ".join(
                  f"{k} {e:.2e}" for k, e in errs.items()))
        _require(max(errs.values()) <= 1e-3, f"{what}: gradients disagree")
        m.zero_grad(set_to_none=True)

    def timed(what, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        fn()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        ms = _time_ms(fn, iters=5, warmup=1)
        print(f"[{what}] {n} points: {ms:.3f} ms device time per call, "
              f"peak memory {peak:.1f} MiB; launches {launches}")
        _require(launches == {}, f"{what}: the classic lattice launched a "
                 f"kernel of the port")
        paths[what] = (launches, 1)

    # ------------------------------------- the autograd nablas, no_grad
    with torch.no_grad():
        out = sdf.forward_sdf_nablas(x)
        ref = sdf_cpu.forward_sdf_nablas(xc)
        parts = []
        for k in ("sdf", "h", "nablas"):
            _require(bool(torch.isfinite(out[k]).all()), f"{k} not finite")
            parts.append((k, _err(out[k][:N_FIELD_CPU].cpu(), ref[k]),
                          1e-5 + 1e-4 * float(ref[k].abs().max()),
                          "the decoder's matmuls and the lattice sums in "
                          "another order"))
        _check("field classic sdf nablas vs cpu", N_FIELD_CPU, parts)
    with torch.no_grad():
        timed("field classic sdf nablas",
              lambda: sdf.forward_sdf_nablas(x))
    # ------------------ the eikonal step through the nablas' 2nd order
    grads_vs_cpu(sdf, sdf_cpu, eik_loss, "field classic sdf eikonal step")
    timed("field classic sdf eikonal step", lambda: step(sdf, eik_loss, x))
    # ---------------------------------------------- the density step
    grads_vs_cpu(nerf, nerf_cpu, nerf_loss, "field classic nerf step")
    timed("field classic nerf step", lambda: step(nerf, nerf_loss, x))


def _gs_params(n: int, seed: int) -> dict:
    """bench.py:404-411's scene from numpy: means U[-1,1], scales
    U[0.002,0.02], unit quats, opacities U[0.3,0.9], colours U[0,1]."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(n, 4))
    p = {"means": r.uniform(-1.0, 1.0, (n, 3)),
         "scales": r.uniform(0.002, 0.02, (n, 3)),
         "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
         "opac": r.uniform(0.3, 0.9, (n, 1)),
         "cols": r.uniform(0.0, 1.0, (n, 3))}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _gs_camera(dev):
    """bench.py:412-413: w2c = I with [2, 3] = 3, f = 500 at 512²."""
    import torch

    w2c = torch.eye(4, device=dev)
    w2c[2, 3] = 3.0
    intr = torch.tensor([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]],
                        device=dev)
    return w2c, intr


def _gs_render(p: dict, cam, normalize: bool = False) -> dict:
    """The serving render (bench.py:415-419), or with the quats normalized
    inside the call as the train step's loss has them
    (bench_render.py:358-365)."""
    import torch
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    q = p["quats"]
    if normalize:
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return GS.rasterize_gaussians_tiled(
        p["means"], p["scales"], q, p["opac"], p["cols"], *cam, GS_HW,
        blend_backend="pallas", **GS_CFG)


def _gs_kernel_phases(p: dict, cam, kernels) -> None:
    """B17 and B18 at the bench scene's own per-tile attrs (the stages of
    `rasterize_gaussians_tiled` up to the blend), with upstream gradients
    from numpy."""
    import torch
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS
    from nr3d_lib_tpu_torch.ops import _build

    src = "nr3d_lib_tpu_torch/csrc/gaussian_blend.cu"
    rep = "nr3d_lib_tpu/graphics/gaussian_splatting.py"
    tile = GS_CFG["tile"]
    with torch.no_grad():
        attrs, origin, _, _ = GS._tile_attrs(
            p["means"], p["scales"], p["quats"], p["opac"], p["cols"], *cam,
            GS_HW, **GS_CFG)
    n_t, _, k = attrs.shape
    n_px = tile * tile
    n_live = int((attrs[:, 10] > 0).sum())
    n_sat = int(((attrs[:, 5] >= 0.999) & (attrs[:, 10] > 0)).sum())
    pairs = n_px * n_live                  # the work this scene's data needs
    rng = np.random.default_rng(31)
    g = tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        attrs.device) for s in ((n_t, n_px, 3), (n_t, n_px), (n_t, n_px)))
    bg, floor = (0.0, 0.0, 0.0), 1.0 / 255.0
    # B18's data-dependent work: the (pixel, slot) pairs above the α floor,
    # and the (warp, slot) pairs in which any pixel is (the warps that do
    # a slot's gradients; the others skip it)
    with torch.no_grad():
        above = GS._alpha_parts(attrs, origin, tile, floor)[5]  # [T, P, K]
        n_above = int(above.sum())
        warp_pairs = n_t * (n_px // 32) * k
        warp_hits = int(above.view(n_t, n_px // 32, 32, k).any(2).sum())
        # B17's warps (8 x 4 boxes): the (warp, slot) pairs some pixel
        # takes, the live ones, and those its cull keeps (its plain mirror)
        wp = GS._warp_pixels(tile).to(attrs.device)
        b17_hits = int(above[:, wp.view(-1)].view(n_t, *wp.shape, k)
                       .any(2).sum())
        del above
        b17_live = n_live * wp.shape[0]
        b17_kept = int(GS.gs_blend_cull_plain(attrs, origin, tile,
                                              floor).sum())
    label = (f"{n_t} tiles of {tile}² x {k} slots, {n_live} live "
             f"({n_sat} with opacity ≥ 0.999), {pairs:,} (pixel, slot) pairs")

    # ------------------------------------------------------ B17 gs_blend
    out_k = GS._fwd_cuda(attrs, origin, bg, tile, floor)
    out_p = GS.gs_blend_plain(attrs, origin, bg, tile, floor)
    err = _check(f"B17 gs_blend, {label}", n_t, [
        (what, _err(a, b), 1e-5 * float(b.abs().max()) + 1e-7,
         "sums over the slots in another order; the plain cumprod is a "
         "parallel scan on the card")
        for what, a, b in zip(("rgb", "acc", "depth"), out_k, out_p)])
    ms = _time_ms(lambda: GS._fwd_cuda(attrs, origin, bg, tile, floor))
    plain_ms = _time_ms(lambda: GS.gs_blend_plain(attrs, origin, bg, tile,
                                                  floor), iters=5)
    # each pair: dx, dy 2; md 9; the exponent's scale 1, expf 1; × op 1;
    # clip 2; live/floor test and select 3; vw 1; acc, rgb, depth 4 FMAs
    # (8); the transmittance 3 → 31; bytes: attrs and origins read,
    # rgb/acc/depth written
    io = n_t * (11 * k * 4 + 8) + n_t * n_px * 5 * 4
    bound = _bound(io, pairs * 31)
    # the issue ceiling at the kept pairs: the warp instructions a kept
    # (warp, slot) pair issues, counted in the SASS of the library this
    # run built (B17's walk loop: its instructions over its MUFU.EX2s), at
    # 4 a clock on each of the card's SMs at its top SM clock
    mhz = _sm_clock_mhz()
    n_sm = torch.cuda.get_device_properties(attrs.device) \
        .multi_processor_count
    per_pair = _walk_per_pair(next(
        code for fn, code in _sass_functions(
            _build._lib_path("gaussian_blend")).items()
        if "gs_blend_kernel" in fn))
    issue_ms = None if per_pair is None else \
        b17_kept * per_pair / (4 * n_sm * mhz * 1e6) * 1e3
    ceiling = ("not measured (no alpha loop found in the SASS)"
               if issue_ms is None else
               f"{issue_ms:.4f} ms ({per_pair:g} instructions a pair in "
               f"this build's SASS, {n_sm} SMs at {mhz:.0f} MHz)")
    print(f"[B17 gs_blend] kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
          f"bound {bound[0]:.4f} ms ({bound[1]}); issue ceiling at the "
          f"kept pairs {ceiling} | library: none | (warp, slot) pairs: "
          f"{b17_kept:,} kept by the cull, {b17_hits:,} taken, {b17_live:,} "
          f"live, {warp_pairs:,} in all")
    _kernel_row(kernels, name="gs_blend (B17)", key="gs_blend",
                path="gs render", source=src, replaces=f"{rep}:197",
                err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                pairs=pairs, warp_slot_pairs=warp_pairs,
                warp_slot_live=b17_live, warp_slot_hits=b17_hits,
                warp_slot_kept=b17_kept, issue_ms_kept=issue_ms,
                instructions_per_kept_pair=per_pair)

    # ------------------------------------------------- B18 gs_blend_bwd
    d_k = GS._bwd_cuda(attrs, origin, *g, bg, tile, floor)
    d_p = GS.gs_blend_bwd_plain(attrs, origin, *g, bg, tile, floor)
    names = ("mu_x", "mu_y", "c00", "c01", "c11", "opacity", "r", "g", "b",
             "depth", "live")
    err = _check(f"B18 gs_blend_bwd, {label}", n_t, [
        (f"d{names[r]}", _err(d_k[:, r], d_p[:, r]),
         1e-4 * float(d_p[:, r].abs().max()) + 1e-9,
         "pixel sums and suffix sums over the slots in another order, "
         "divided by 1 - alpha") for r in range(11)])
    ms = _time_ms(lambda: GS._bwd_cuda(attrs, origin, *g, bg, tile, floor))
    plain_ms = _time_ms(lambda: GS.gs_blend_bwd_plain(
        attrs, origin, *g, bg, tile, floor), iters=5)
    # each pair: the forward's alpha and transmittance (~18), dvw 10, the
    # suffix sum and dL/dalpha 5, the chain to md 3, ten gradients ~24,
    # their sums over the pixels 10 → 70; bytes: attrs, origins and the
    # upstream gradients read, the slot gradients written
    io = n_t * (11 * k * 4 + 8) + n_t * n_px * 5 * 4 + n_t * 11 * k * 4
    bound = _bound(io, pairs * 70)
    print(f"[B18 gs_blend_bwd] kernel {ms:.4f} ms | plain {plain_ms:.4f} ms "
          f"| bound {bound[0]:.4f} ms ({bound[1]}) | library: none | "
          f"{n_above:,} pairs above the α floor; {warp_hits:,} of "
          f"{warp_pairs:,} (warp, slot) pairs taken")
    _kernel_row(kernels, name="gs_blend_bwd (B18)", key="gs_blend_bwd",
                path="gs train step", source=src, replaces=f"{rep}:247",
                err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                pairs=pairs, pairs_above_floor=n_above,
                warp_slot_pairs=warp_pairs, warp_slot_hits=warp_hits)


def _gs_serve(p: dict, p_cpu: dict, cam, smi: str, paths: dict) -> float:
    """Path E serving: N_RENDERS timed renders (1 B17 each), the CPU port's
    render of the same scene pixel by pixel. Returns the CPU render's
    seconds."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build

    with torch.no_grad():
        _gs_render(p, cam)                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        times = []
        for _ in range(N_RENDERS):
            t0 = time.perf_counter()
            out = _gs_render(p, cam)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.LAUNCHES)
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        med = statistics.median(times)
        q1, _, q3 = statistics.quantiles(times, n=4)
        n_px = GS_HW[0] * GS_HW[1]
        dropped = int(out["n_dropped_pairs"])
        print(f"[gs render] {GS_N} gaussians at {GS_HW[0]}x{GS_HW[1]} x "
              f"{N_RENDERS} renders on {smi}: median {med:.3f} ms/frame "
              f"(quartiles {q1:.3f}/{q3:.3f}, min {min(times):.3f}, max "
              f"{max(times):.3f}) -> {1e3 / med:.2f} fps, "
              f"{n_px / med / 1e3:.2f} Mpix/s | peak memory {peak_mib:.1f} "
              f"MiB | n_dropped_pairs {dropped}")
        print(f"[gs render] launches in the {N_RENDERS} timed renders: "
              f"{launches}")
        _require(launches == {"gs_blend": N_RENDERS},
                 f"gs render: launches {launches}, expected "
                 f"{{'gs_blend': {N_RENDERS}}}")
        for k in ("rgb", "alpha", "depth"):
            _require(bool(torch.isfinite(out[k]).all()), f"gs {k} not finite")
        mean_a = float(out["alpha"].mean())
        print(f"[gs render] all outputs finite; mean alpha {mean_a:.4f}")
        _require(mean_a > 0.1, "the gaussian render is trivially empty")
        _profile(lambda: _gs_render(p, cam), med, "gs render")

        t0 = time.perf_counter()
        ref = _gs_render(p_cpu, tuple(c.cpu() for c in cam))
        cpu_s = time.perf_counter() - t0
    e = torch.stack([(out[k].cpu() - ref[k]).abs().reshape(n_px, -1).amax(-1)
                     for k in ("rgb", "alpha", "depth")]).amax(0)
    share = float((e <= 1e-4).float().mean())
    d_cpu = int(ref["n_dropped_pairs"])
    print(f"[gs render] GPU vs CPU port ({cpu_s:.1f} s on the CPU): "
          f"{share * 100:.2f}% of pixels agree within 1e-4 on rgb, alpha and "
          f"depth ({float((e <= 1e-3).float().mean()) * 100:.2f}% within "
          f"1e-3; max {float(e.max()):.3e}); n_dropped_pairs card {dropped} "
          f"cpu {d_cpu} ({'equal' if dropped == d_cpu else 'NOT equal'})")
    _require(share >= 0.99, "gs render: GPU and CPU renders disagree")
    paths["gs render"] = (launches, N_RENDERS)
    return cpu_s


def _gs_loss(p: dict, cam, gt):
    """bench_render.py:358-366: MSE of the render to the target."""
    import torch

    return torch.mean((_gs_render(p, cam, normalize=True)["rgb"] - gt) ** 2)


def _gs_step_vs_cpu(params: dict, cam, gt, cpu_render_s: float) -> None:
    """One step's loss and gradients on the card against the CPU port from
    the same parameters. The gaussian count is cut for this check alone
    when the CPU step, estimated as 3x the CPU render, would exceed
    CPU_STEP_BUDGET_S."""
    import torch
    from nr3d_lib_tpu_torch import bridge

    n = GS_N
    while n > 10_000 and 3.0 * cpu_render_s * n / GS_N > CPU_STEP_BUDGET_S:
        n //= 2
    if n < GS_N:
        print(f"[gs step vs cpu] cut to {n} of {GS_N} gaussians: the CPU "
              f"render of {GS_N} took {cpu_render_s:.1f} s")
    sub = {k: v[:n] for k, v in params.items()}
    res = []
    for dev in (gt.device, torch.device("cpu")):
        p = bridge.gaussians_from_jax(sub, device=dev)
        t0 = time.perf_counter()
        loss = _gs_loss(p, tuple(c.to(dev) for c in cam), gt.to(dev))
        loss.backward()
        res.append((float(loss.detach()), {k: t.grad.cpu() for k, t in
                                           p.items()},
                    time.perf_counter() - t0))
    (loss_g, gg, _), (loss_c, gc, cpu_step_s) = res
    rel_loss = abs(loss_g - loss_c) / abs(loss_c)
    errs = {k: float(torch.linalg.norm(gg[k] - gc[k]) /
                     max(float(torch.linalg.norm(gc[k])), 1e-12)) for k in gc}
    print(f"[gs step vs cpu] {n} gaussians, CPU step {cpu_step_s:.1f} s: "
          f"loss card {loss_g:.7f} cpu {loss_c:.7f}, relative {rel_loss:.2e} "
          f"(tolerance 1e-4); gradients, relative L2 per tensor (tolerance "
          f"1e-4: both sides sort the same int64 keys stably, so only the "
          f"order of the pixel and scatter sums differs): " +
          ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    _require(rel_loss <= 1e-4, "gs: card and CPU step losses disagree")
    _require(max(errs.values()) <= 1e-4, "gs: card and CPU gradients disagree")


def _gs_train(params: dict, cam, gt, smi: str, paths: dict) -> None:
    """bench_render.py `main_train_gaussian`: Adam(1e-3) over the five
    parameter tensors; 2 warm-up and N_STEPS timed steps of exactly 1 B17
    and 1 B18 each."""
    import torch
    from nr3d_lib_tpu_torch import bridge
    from nr3d_lib_tpu_torch.ops import _build

    p = bridge.gaussians_from_jax(params, device=gt.device)
    opt = torch.optim.Adam(p.values(), lr=1e-3)
    losses = []

    def step():
        opt.zero_grad(set_to_none=True)
        loss = _gs_loss(p, cam, gt)
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    for _ in range(N_WARMUP_STEPS):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    times = []
    for _ in range(N_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    med = statistics.median(times)
    q1, _, q3 = statistics.quantiles(times, n=4)
    vals = [float(v) for v in losses]
    print(f"[gs train] {GS_N} gaussians at {GS_HW[0]}x{GS_HW[1]} x {N_STEPS} "
          f"steps on {smi}: median {med:.3f} ms/step (quartiles "
          f"{q1:.3f}/{q3:.3f}, min {min(times):.3f}, max {max(times):.3f}) | "
          f"peak memory {peak_mib:.1f} MiB")
    print(f"[gs train] loss per step: {' '.join(f'{v:.6f}' for v in vals)}")
    print(f"[gs train] launches in the {N_STEPS} timed steps: {launches}")
    expect = {"gs_blend": N_STEPS, "gs_blend_bwd": N_STEPS}
    _require(launches == expect, f"gs train: launches {launches}, expected "
             f"{expect}")
    _require(all(np.isfinite(vals)), "a gs loss is not finite")
    last5 = float(np.mean(vals[-5:]))
    print(f"[gs train] mean loss of the last 5 steps {last5:.6f} vs the "
          f"first step's {vals[0]:.6f}")
    _require(last5 < vals[0], "the gs loss did not fall")
    _profile(step, med, "gs train step")
    paths["gs train step"] = (launches, N_STEPS)


# the example trainers as programs (examples_torch/): each at its default
# model, ray count and evaluation sizes, --iters cut to fit the run; the
# NeuS object under --w4 and the forest under --brick for a few steps, so
# that the trainer path runs B1-B5 and the forest forms of B6-B9. (name,
# flags, what a run must launch at least once, resume step k)
TRAINER_RUNS = (
    ("train_neus_object", ["--iters", "300"], ("gather1d",), 15),
    ("train_nerf_synthetic", ["--iters", "300"], ("gather1d",), 15),
    ("train_forest_street", ["--iters", "200"], (), 15),
    ("train_dynamic_scene", ["--iters", "200"], ("gather1d",), 15),
    ("train_generative_shapes", ["--iters", "200"], (), 15),
    ("train_conditional_dynamic", ["--iters", "200"], (), 15),
    ("train_neus_object", ["--w4", "--iters", "20", "--mesh_res", "64"],
     ("brick4_fwd", "brick4_bwd", "brick4_dydx", "brick4_bwd2", "gather1d"),
     3),
    ("train_forest_street", ["--brick", "--iters", "20"],
     ("brick_fwd_b", "brick_bwd_b", "brick_dydx_b", "brick_bwd2_b"), 3),
)
RESUME_RTOL = 1e-5


def _trainer_phase(dev, smi: str, paths: dict) -> None:
    """Run each example trainer through its `main([...])` on the card and
    check what it wrote, that the held-out PSNR rose above the untrained
    model's, that the loss fell (the mean of the last five steps below the
    first five's), the launches, and that a run resumed from a checkpoint
    at step k takes steps k and k+1 with the uninterrupted run's losses
    (within RESUME_RTOL relative: the backward kernels' float atomics are
    not bitwise between runs)."""
    import importlib
    import tempfile
    import torch
    from examples_torch.common import resume_losses
    from nr3d_lib_tpu_torch.ops import _build

    for name, flags, kernels_used, k in TRAINER_RUNS:
        mod = importlib.import_module(f"examples_torch.{name}")
        label = " ".join([name] + [f for f in flags if f.startswith("--w")
                                   or f == "--brick"])
        with tempfile.TemporaryDirectory() as out:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            res = mod.main(flags + ["--out", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
            missing = [f for f in mod.OUTPUTS
                       if not os.path.isfile(os.path.join(out, f))]
            straight, resumed = resume_losses(
                lambda: mod.setup(mod.parse(flags)), k,
                os.path.join(out, "resume"))
        iters = len(res["losses"])
        first5 = float(np.mean(res["losses"][:5]))
        last5 = float(np.mean(res["losses"][-5:]))
        cham = res.get("chamfer")
        print(f"[trainer {label}] {iters} iters, {res['train_s']:.1f} s of "
              f"training, {wall:.1f} s in all, {res['ms_per_iter']:.1f} "
              f"ms/iter | val PSNR {res['psnr']:.2f} dB (untrained "
              f"{res['psnr_init']:.2f})"
              + (f", chamfer {cham:.3e}" if cham is not None else "")
              + f" | loss, mean of the first / last 5 steps {first5:.5f} / "
              f"{last5:.5f} | peak memory {peak_mib:.1f} MiB | launches "
              f"{launches} | {smi}")
        rel = [abs(a - b) / max(abs(a), 1e-12)
               for a, b in zip(straight, resumed)]
        print(f"[trainer {label}] resume at step {k}: losses of steps {k}, "
              f"{k + 1} uninterrupted {straight}, resumed {resumed}, "
              f"relative {max(rel):.2e} (tolerance {RESUME_RTOL:.0e})")
        _require(not missing, f"{label}: missing outputs {missing}")
        _require(np.isfinite(res["psnr"]) and res["psnr"] > res["psnr_init"],
                 f"{label}: the PSNR did not rise")
        _require(all(np.isfinite(res["losses"])) and last5 < first5,
                 f"{label}: the loss did not fall")
        _require(cham is None or np.isfinite(cham), f"{label}: chamfer")
        for kname in kernels_used:
            _require(launches.get(kname, 0) > 0,
                     f"{label}: {kname} was not launched")
        _require(max(rel) <= RESUME_RTOL, f"{label}: the resumed run's "
                 f"losses differ")
        if "--brick" in flags:
            _street_brick_vs_cpu(mod, flags, label)
        paths[f"trainer {label}"] = (launches, iters)


def _street_brick_vs_cpu(mod, flags, label: str, warm: int = 10) -> None:
    """The forest forms of B6-B9 at the street's shapes (6 blocks, the
    trainer's ray count and segment march), which the kernel phases hold
    only on FOREST_CFG: the trainer's model after `warm` steps, one step's
    loss and gradients on rays of the street's law against the CPU port
    from the same state, and that this card step launched all four."""
    import torch
    from examples_torch.common import generator
    from nr3d_lib_tpu_torch.ops import _build

    tr = mod.setup(mod.parse(flags))
    for it in range(warm):
        tr.step(it)
    cpu = mod.setup(mod.parse(flags + ["--cpu"])).model
    cpu.load_state_dict({k: v.cpu() for k, v in
                         tr.model.state_dict().items()})
    b = tr.sample(tr.rays, generator(tr.model.device, 99))
    _build.LAUNCHES.clear()
    _step_vs_cpu(tr.model, cpu, b["o"], b["d"], _cpu_seconds(
        lambda oo, dd: _forest_loss(cpu, oo, dd), b["o"], b["d"]),
        f"trainer {label}", loss=_forest_loss)
    launched = dict(_build.LAUNCHES)
    for kname in ("brick_fwd_b", "brick_bwd_b", "brick_dydx_b",
                  "brick_bwd2_b"):
        _require(launched.get(kname, 0) > 0, f"{label}: the step held "
                 f"against the CPU did not launch {kname}")


def _seed_occupancy(model) -> None:
    """A seeded 15% occupancy grid (experiments/bench_render.py seeds the
    same share, so the compressed paths have real sparsity)."""
    import torch

    occ = np.random.default_rng(5).uniform(size=(64, 64, 64)) < 0.15
    model.accel.occ.val_grid.copy_(torch.from_numpy(occ.astype(np.float32)))


def _cpu_seconds(fn, o, d, n_try: int = 512) -> float:
    """Seconds the CPU port would take for `fn(o, d)` on all the rays,
    scaled from `n_try` of them (under no_grad)."""
    import torch

    t0 = time.perf_counter()
    with torch.no_grad():
        fn(o[:n_try].cpu(), d[:n_try].cpu())
    return (time.perf_counter() - t0) * o.shape[0] / n_try


def _cpu_twin(model, cls, cfg):
    """The same model on the CPU (plain versions), from the same state."""
    cpu = cls(**cfg, seed=0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not (REPO / "nr3d_lib_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nr3d_lib_tpu_torch import bridge
    from nr3d_lib_tpu_torch.models.fields.nerf import PermutoNeRF
    from nr3d_lib_tpu_torch.models.fields.sdf import PermutoSDF
    from nr3d_lib_tpu_torch.models.fields_forest import LoTDForestNeuSModel
    from nr3d_lib_tpu_torch.models.model_base import (LoTDNeRFModel,
                                                      LoTDNeuSModel)
    from nr3d_lib_tpu_torch.models.model_families import \
        DynamicPermutoNeuSModel
    from nr3d_lib_tpu_torch.ops import _build
    from nr3d_lib_tpu_torch.ops import lotd_brick as B, lotd_brick4 as B4

    t_start = time.perf_counter()

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda} | device_count "
          f"{torch.cuda.device_count()} | allow_tf32 matmul/cudnn: "
          f"{torch.backends.cuda.matmul.allow_tf32}/"
          f"{torch.backends.cudnn.allow_tf32}")

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.KERNEL_SOURCES)} sources, nvcc "
          f"{' '.join(_build.NVCC_FLAGS)}: {time.perf_counter() - t0:.2f} s")
    for name in _build.KERNEL_SOURCES:
        for line in _build.PTXAS_REPORT.get(name, "(cached)").splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "(cached)")):
                print(f"[build] {name}: {line.strip()}")

    # ----------------------------------------------------------- models
    def seeded(cls, cfg, enc_of, seed, occupancy=True):
        m = cls(**cfg, seed=0)
        _seed_weights(m, enc_of(m), seed)
        t0 = time.perf_counter()
        m.populate()
        torch.cuda.synchronize()
        print(f"[populate] {cls.__name__} "
              f"({enc_of(m).meta.total_rows} table rows, F="
              f"{enc_of(m).n_feats}): {(time.perf_counter() - t0) * 1e3:.1f}"
              f" ms")
        if occupancy:
            _seed_occupancy(m)
        return m

    def neus_enc(m):
        return m.field.implicit_surface.encoding

    model = seeded(LoTDNeuSModel, PROD_CFG, neus_enc, 1)
    neus2 = seeded(LoTDNeuSModel, NEUS_F2_CFG, neus_enc, 3)
    nerf = seeded(LoTDNeRFModel, NERF_CFG, lambda m: m.field.encoding, 2)
    # the dynamic query samples without marching: its per-time-key grids
    # keep what populate's EMA update put there
    dyn = seeded(DynamicPermutoNeuSModel, DYN_CFG,
                 lambda m: m.field.implicit_surface.bank, 4, occupancy=False)
    o, d = (torch.from_numpy(a).to(dev) for a in _rays(N_RAYS, seed=0))
    o8, d8 = (torch.from_numpy(a).to(dev)
              for a in _rays(N_RAYS_NERF, seed=0))
    ts_extra = {"ts": torch.from_numpy(np.random.default_rng(6).uniform(
        -1.0, 1.0, N_RAYS).astype(np.float32)).to(dev)}
    kernels, paths = [], {}

    # --------------------------------------------------- kernel phases
    x3 = _f4_kernel_phases(model, o, d, kernels)
    _occ_march_phase(dev, kernels)
    x3b = _f2_kernel_phases(nerf, neus2, o8, d8, o, d, kernels)
    _permuto4_kernel_phases(dyn, o, d, ts_extra["ts"], kernels)

    # ----------------------------------- slices 1 and 2: the F=4 NeuS
    cpu = _cpu_twin(model, LoTDNeuSModel, PROD_CFG)
    launches, cpu_s = _serve(model, cpu, o, d, {
        "brick4_fwd": 6, "brick4_dydx": 1, "occ_march_budget": 1},
        "f4 render", smi)
    paths["f4 render"] = (launches, N_RENDERS)
    _launch_sizes(model, o, d, B4, "B1", kernels, "brick4_fwd")
    paths["f4 autograd nablas"] = (_autograd_nablas(model, x3, "brick4"), 1)
    _step_vs_cpu(model, cpu, o, d, cpu_s, "f4")
    paths["f4 train step"] = (_train(
        model, o, d, smi, "f4", {"brick4_fwd": 6, "brick4_bwd": 1,
                                 "brick4_dydx": 1, "brick4_bwd2": 1,
                                 "occ_march_budget": 1}, {"brick4_fwd": 1}),
        N_STEPS)
    _step_points(model, o, d, kernels, B4, {"_bwd_cuda": "brick4_bwd",
                                            "_bwd2_cuda": "brick4_bwd2"})

    # ------------------------------------ path A: the F=2 NeRF serving
    nerf_cpu = _cpu_twin(nerf, LoTDNeRFModel, NERF_CFG)
    launches, _ = _serve(nerf, nerf_cpu, o8, d8, {"brick_fwd": 1,
                                                  "occ_march_budget": 1},
                         "nerf render", smi)
    paths["nerf render"] = (launches, N_RENDERS)
    nerf.ray_query_cfg = {"query_mode": "march_occ"}   # the default mode
    launches, _ = _serve(nerf, nerf_cpu, o8, d8, {"brick_fwd": 1,
                                                  "gather1d": 1},
                         "nerf march_occ render", smi, n_renders=1)
    paths["nerf march_occ render"] = (launches, 1)

    # ------------------------------------ path B: the F=2 NeuS
    cpu2 = _cpu_twin(neus2, LoTDNeuSModel, NEUS_F2_CFG)
    launches, cpu_s = _serve(neus2, cpu2, o, d, {
        "brick_fwd": 6, "brick_dydx": 1, "occ_march_budget": 1},
        "f2 render", smi)
    paths["f2 render"] = (launches, N_RENDERS)
    _launch_sizes(neus2, o, d, B, "B6", kernels, "brick_fwd")
    paths["f2 autograd nablas"] = (_autograd_nablas(neus2, x3b, "brick"), 1)
    _step_vs_cpu(neus2, cpu2, o, d, cpu_s, "f2")
    paths["f2 train step"] = (_train(
        neus2, o, d, smi, "f2", {"brick_fwd": 6, "brick_bwd": 1,
                                 "brick_dydx": 1, "brick_bwd2": 1,
                                 "occ_march_budget": 1}, {"brick_fwd": 1}),
        N_STEPS)
    _step_points(neus2, o, d, kernels, B, {"_bwd_cuda": "brick_bwd"})

    # ---------------- A8b: the F=4 NeRF serving, in both NeRF modes
    nerf4 = seeded(LoTDNeRFModel, NERF_W4_CFG, lambda m: m.field.encoding,
                   22)
    nerf4_cpu = _cpu_twin(nerf4, LoTDNeRFModel, NERF_W4_CFG)
    for mode, label in (("march_occ_compressed", "nerf_w4_serve_8192"),
                        ("march_occ", "nerf_w4_serve_8192 march_occ")):
        nerf4.ray_query_cfg = dict(NERF_W4_CFG["ray_query_cfg"]) \
            if mode == "march_occ_compressed" else {"query_mode": mode}
        march = "occ_march_budget" if mode == "march_occ_compressed" \
            else "gather1d"
        launches, _ = _serve(nerf4, nerf4_cpu, o8, d8, {"brick4_fwd": 1,
                                                        march: 1},
                             label, smi)
        paths[label] = (launches, N_RENDERS)

    # ------- A8b: the NeRF train step (nerf_ray_query_fixed; B6 and B7)
    nerf_fx = LoTDNeRFModel(**NERF_FIXED_CFG, seed=0)
    _seed_weights(nerf_fx, nerf_fx.field.encoding, 23)
    nerf_fx_cpu = _cpu_twin(nerf_fx, LoTDNeRFModel, NERF_FIXED_CFG)
    _step_vs_cpu(nerf_fx, nerf_fx_cpu, o, d, _cpu_seconds(
        lambda oo, dd: _fixed_loss(nerf_fx_cpu, oo, dd), o, d),
        "nerf_f2_fixed_train_4096", loss=_fixed_loss)
    paths["nerf_f2_fixed_train_4096"] = (_train(
        nerf_fx, o, d, smi, "nerf_f2_fixed_train_4096",
        {"brick_fwd": 1, "brick_bwd": 1}, {}, loss_fn=_fixed_loss,
        lifecycle=False), N_STEPS)

    # --- A8b: the NeuS train step (coarse_multi_upsample; B6 to B9)
    neus_c = LoTDNeuSModel(**NEUS_COARSE_CFG, seed=0)
    _seed_weights(neus_c, neus_c.field.implicit_surface.encoding, 24)
    neus_c.populate()
    neus_c_cpu = _cpu_twin(neus_c, LoTDNeuSModel, NEUS_COARSE_CFG)
    _step_vs_cpu(neus_c, neus_c_cpu, o, d, _cpu_seconds(
        lambda oo, dd: _step_loss(neus_c_cpu, oo, dd), o, d),
        "neus_f2_coarse_train_4096")
    paths["neus_f2_coarse_train_4096"] = (_train(
        neus_c, o, d, smi, "neus_f2_coarse_train_4096",
        {"brick_fwd": 5, "brick_dydx": 1, "brick_bwd": 1, "brick_bwd2": 1},
        {}, lifecycle=False), N_STEPS)

    # -------- A11: the forest NeuS serving (B6 and B8 with bidx)
    forest = LoTDForestNeuSModel(**FOREST_CFG, seed=0)
    _seed_weights(forest, forest.field.implicit_surface.encoding, 25)
    forest.populate()
    of, df = (torch.from_numpy(a).to(dev)
              for a in _rays(N_RAYS_FOREST, seed=0, radius=2.5))
    forest_cpu = _cpu_twin(forest, LoTDForestNeuSModel, FOREST_CFG)
    cpu_s = _cpu_seconds(lambda oo, dd: forest_cpu.ray_query(
        forest_cpu.ray_test(oo, dd)), of, df)
    n_cpu = N_RAYS_FOREST
    while n_cpu > 256 and cpu_s * n_cpu / N_RAYS_FOREST > CPU_STEP_BUDGET_S:
        n_cpu //= 2
    _forest_kernel_phases(forest, of, df, kernels)
    launches, _ = _serve(forest, forest_cpu, of, df, {
        "brick_fwd_b": 5, "brick_dydx_b": 1}, "forest_serve_8192", smi,
        cpu_rays=n_cpu)
    paths["forest_serve_8192"] = (launches, N_RENDERS)

    # ---- A11: the forest NeuS train step (B6 to B9 with bidx), as
    # examples/train_forest_street.py:119-147 at the serving model's width
    ftrain = LoTDForestNeuSModel(**FOREST_CFG, seed=0)
    _seed_weights(ftrain, ftrain.field.implicit_surface.encoding, 26)
    ftrain.populate()
    oft, dft = (torch.from_numpy(a).to(dev)
                for a in _rays(N_RAYS, seed=1, radius=2.5))
    ftrain_cpu = _cpu_twin(ftrain, LoTDForestNeuSModel, FOREST_CFG)
    _forest_train_kernel_phases(ftrain, oft, dft, kernels)
    _step_vs_cpu(ftrain, ftrain_cpu, oft, dft, _cpu_seconds(
        lambda oo, dd: _forest_loss(ftrain_cpu, oo, dd), oft, dft),
        "forest_train_4096", loss=_forest_loss)
    paths["forest_train_4096"] = (_train(
        ftrain, oft, dft, smi, "forest_train_4096",
        {"brick_fwd_b": 5, "brick_dydx_b": 1, "brick_bwd_b": 1,
         "brick_bwd2_b": 1}, {"brick_fwd_b": 1}, loss_fn=_forest_loss,
        lr=1e-2, gated=True), N_STEPS)

    # ---- examples/train_neus_object.py: the default NeuS mode, the
    # sphere trace, the example's train step; the NeRF multi-upsample
    _object_paths(dev, smi, paths)
    # ---- the three example trainers at their default flags: the
    # classic LoTD (no backend key), plain PyTorch
    _classic_lotd_paths(dev, smi, paths)
    nerf.ray_query_cfg = {"query_mode": "march_occ_multi_upsample_compressed"}
    launches, _ = _serve(nerf, nerf_cpu, o8, d8, {"brick_fwd": 2,
                                                  "occ_march_budget": 1},
                         "nerf_f2_mup_serve_8192", smi)
    paths["nerf_f2_mup_serve_8192"] = (launches, N_RENDERS)

    # ------------------------- path C: the dynamic (x,t) permuto NeuS
    dyn_cpu = _cpu_twin(dyn, DynamicPermutoNeuSModel, DYN_CFG)
    launches, cpu_s = _serve(dyn, dyn_cpu, o, d, {
        "permuto4_fwd": 4, "permuto4_dydx": 1}, "dyn render", smi,
        extra=ts_extra)
    paths["dyn render"] = (launches, N_RENDERS)
    _step_vs_cpu(dyn, dyn_cpu, o, d, cpu_s, "dyn", ts_extra)
    paths["dyn train step"] = (_train(
        dyn, o, d, smi, "dyn", {"permuto4_fwd": 4, "permuto4_bwd": 1,
                                "permuto4_dydx": 1}, {"permuto4_fwd": 1},
        ts_extra), N_STEPS)

    # --------------- the F=2 cell permuto: kernel phases, fields, path D
    pathd = seeded(DynamicPermutoNeuSModel, PATHD_CFG,
                   lambda m: m.field.implicit_surface.bank, 7,
                   occupancy=False)
    fields = []
    for cls, seed in ((PermutoSDF, 10), (PermutoNeRF, 11)):
        f = cls(permuto_cfg=FIELD_PERMUTO, seed=0, device=dev)
        p = f.bank.flattened_params
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.random.default_rng(seed).uniform(
                -0.1, 0.1, tuple(p.shape)).astype(np.float32)))
        cpu_f = cls(permuto_cfg=FIELD_PERMUTO, seed=0, device="cpu")
        cpu_f.load_state_dict({k: v.cpu() for k, v in f.state_dict().items()})
        fields.append((f, cpu_f))
    (sdf3, sdf3_cpu), (nerf3, nerf3_cpu) = fields
    _permuto_kernel_phases(pathd, sdf3, o, d, ts_extra["ts"], kernels)
    _field_phase(sdf3, nerf3, sdf3_cpu, nerf3_cpu, o, d, paths, smi)

    pathd_cpu = _cpu_twin(pathd, DynamicPermutoNeuSModel, PATHD_CFG)
    launches, cpu_s = _serve(pathd, pathd_cpu, o, d, {
        "permuto_fwd": 4, "permuto_dydx": 1}, "pathd render", smi,
        extra=ts_extra)
    paths["pathd render"] = (launches, N_RENDERS)
    _step_vs_cpu(pathd, pathd_cpu, o, d, cpu_s, "pathd", ts_extra)
    paths["pathd train step"] = (_train(
        pathd, o, d, smi, "pathd", {"permuto_fwd": 4, "permuto_bwd": 1,
                                    "permuto_dydx": 1}, {"permuto_fwd": 1},
        ts_extra), N_STEPS)

    # ------------- the classic permutohedral lattice (plain PyTorch)
    _field_phase_classic(o, d, dev, paths, smi)
    _dyn_xla_paths(dev, o, d, ts_extra, smi, paths)
    # ---- A12: EmerNeRF, the generative and conditional dynamic shapes
    _a12_paths(dev, smi, paths, kernels)
    # ---- A7c + A19: the getter grid, the MLP-only fields, bf16
    t_a19 = time.perf_counter()
    _a19_paths(dev, smi, paths)
    print(f"[time] the A7c/A19 phases: {time.perf_counter() - t_a19:.1f} s "
          f"on {smi}")
    # ---- A14: DMTet, pose refinement, the pack and maths layers
    t_a14 = time.perf_counter()
    w4, w4_cpu = _a14_paths(dev, smi, paths)
    print(f"[time] the A14 phases: {time.perf_counter() - t_a14:.1f} s on "
          f"{smi}")
    # ---- A15: data-parallel training, the configs, chunking, the viewer,
    # the profiler and the sharded checkpoint
    t_a15 = time.perf_counter()
    _a15_paths(dev, smi, paths, w4, w4_cpu)
    del w4, w4_cpu
    print(f"[time] the A15 phases: {time.perf_counter() - t_a15:.1f} s on "
          f"{smi}")

    # ------------------------- path E: 3D Gaussian splatting (B17, B18)
    gs_params = _gs_params(GS_N, seed=21)
    gs_cam = _gs_camera(dev)
    gs_gt = torch.from_numpy(np.random.default_rng(3).uniform(
        size=GS_HW + (3,)).astype(np.float32)).to(dev)
    gs_p = bridge.gaussians_from_jax(gs_params, device=dev)
    _gs_kernel_phases(gs_p, gs_cam, kernels)
    cpu_s = _gs_serve(gs_p, bridge.gaussians_from_jax(gs_params, "cpu"),
                      gs_cam, smi, paths)
    _gs_step_vs_cpu(gs_params, gs_cam, gs_gt, cpu_s)
    _gs_train(gs_params, gs_cam, gs_gt, smi, paths)

    # ------------- the example trainers as programs (examples_torch/)
    _trainer_phase(dev, smi, paths)

    for kd in kernels:
        key = kd.pop("key")
        got, calls = paths[kd["path"]]
        kd["launches"] = got.get(key, 0)
        kd["launches_per_call"] = kd["launches"] / calls
        kd["launches_per_call_by_path"] = {
            p: g[key] / c for p, (g, c) in paths.items() if key in g}
        _require(kd["launches"] > 0, f"{kd['name']}: no launch on its path")
    print(f"[time] {len(kernels)} kernel rows, {len(paths)} paths, "
          f"{time.perf_counter() - t_start:.1f} s after the imports")
    print(json.dumps({"kernels": kernels}))
    print(f"[device] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
