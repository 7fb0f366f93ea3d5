#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nr3d_lib_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

1. Prints the card (name, power limit), torch and CUDA versions.
2. Builds every CUDA kernel of the port from `nr3d_lib_tpu_torch/csrc/`
   with nvcc for sm_90a, all sources at once, and prints the build time and
   the ptxas register / shared-memory lines.
3. One phase per kernel at the shapes of the serving render: B1
   (brick4_fwd) at 589,824 points, B3 (brick4_dydx) at 147,456 points, B5
   (gather1d) at 393,216 lookups into a [4096, 64] table. Each compares the
   kernel with its plain PyTorch version on the card (tolerance printed),
   times kernel, plain version and, for B5, the one-call PyTorch
   equivalent with CUDA events after warm-up, and prints the bound.
   Then one phase per training kernel at the train step's shapes (147,456
   packed points): B1 with want_g (brick4_fwd_g), B2 (brick4_bwd) with and
   without dL/dx, and B4 (brick4_bwd2), each held against its plain
   version, timed and bounded the same way.
4. Slice 1, serving: the production F=4 brick-LoTD NeuS (`LoTDNeuSModel`,
   the configuration of experiments/bench_render.py `main_train` kind
   neus_compressed_w4) with seeded weights, a seeded 15% occupancy and
   4096 seeded rays, through populate → ray_test → ray_query under
   torch.no_grad(). Launch counters are zeroed just before the timed
   renders and read just after; every kernel of the path must have run
   (6 B1, 1 B3 and 1 B5 launch per render). The same rays are rendered
   by the port on the CPU (plain versions) and the share of rays whose rgb
   and depth agree within 1e-4 must be ≥ 99%.
5. The nablas by autograd (`forward_sdf` with x requiring grad, then
   `torch.autograd.grad`), the path that runs B1 want_g and B2 with dL/dx,
   against the split nablas of `forward_sdf_nablas` (B3).
6. Slice 2, training: one step's loss and every parameter's gradient on
   the card against the CPU port from the same weights and the same
   uniforms (drawn on the card, replayed on the CPU); then the production
   train step (perturbed query, MSE(rgb, |d|) + 0.1·eikonal, Adam(5e-3),
   `training_before_per_step` every step) for 2 warm-up and 20 timed
   steps that cross an occupancy update: ms/step, Krays/s, peak memory,
   the loss of every step, exact launches per step, and a profile.
7. A `{"kernels": [...]}` JSON line, then the card's name and power limit,
   then the last line `{"ok": true, "device": {...}}`.

TF32 is off for matmuls and cuDNN (`allow_tf32 = False`): the reference
comparisons hold float32 end to end. Every failure raises and the script
exits non-zero; it exits non-zero without printing a result when no CUDA
device is present or when the port's package is not beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
N_RAYS = 4096
N_RENDERS = 10
N_WARMUP_STEPS = 2
N_STEPS = 20              # timed; it = 3..22 crosses the update at it = 16
CPU_STEP_BUDGET_S = 60.0  # the GPU-vs-CPU step check cuts its rays to fit
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores

# the production configuration (experiments/bench_render.py:143-175)
PROD_CFG = dict(
    field_cfg={"surface_cfg": {
        "encoding_cfg": {"lotd_cfg": {"lod_res": [16, 64], "lod_n_feats": 4,
                                      "lod_types": ["Dense", "Hash"],
                                      "hashmap_size": 2 ** 16},
                         "backend": "brick"},
        "decoder_cfg": {"D": 1, "W": 64}},
        "radiance_cfg": {"D": 2, "W": 64}},
    accel_cfg={"resolution": 64, "max_steps_per_ray": 96,
               "step_size": 2.0 / 96},
    ray_query_cfg={"query_mode": "march_occ_multi_upsample_compressed",
                   "compression_factor": 0.25, "march_budget_factor": 0.5})


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def _profile(run, wall_ms: float, what: str = "render") -> None:
    """Device time by kernel over two calls of `run` (torch.profiler), and
    the share of one call's wall time `wall_ms` that the device is busy.
    Only device-side events count (kernels, memsets, copies): an aten op's
    row repeats the device time of the kernels it launched, and a user
    annotation (such as the optimizer step's) spans kernels already
    counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or \
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
    ours = sum(r[0] for r in rows if r[2].startswith(("brick4", "gather1d")))
    print(f"[profile] the port's kernels (brick4_*, gather1d): {ours:.4f} "
          f"ms, {ours / max(total, 1e-9) * 100:.1f}% of the device time")
    for ms, count, key in rows[:12]:
        print(f"[profile]   {ms:8.4f} ms {ms / max(total, 1e-9) * 100:5.1f}% "
              f"x{count:<4.0f} {key[:90]}")


def _rays(n: int, seed: int):
    """experiments/bench_render.py's ray distribution, from numpy."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(n, 3)) * 0.1
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


def _set_weights(model, seed: int) -> None:
    """Seeded weights that give a non-trivial render: table values in
    ±0.1 (the init is ±1e-4) and ln_s = ln(64)/10."""
    import torch

    rng = np.random.default_rng(seed)
    enc = model.field.implicit_surface.encoding
    with torch.no_grad():
        enc.flattened_params.copy_(torch.from_numpy(rng.uniform(
            -0.1, 0.1, enc.n_params).astype(np.float32)))
        model.field.var_ctrl.ln_s.fill_(float(np.log(64.0) / 10.0))


def _step_loss(model, o, d, **query):
    """experiments/bench_render.py:197-221: MSE(rgb, |d|) + 0.1·eikonal
    over the valid packed nablas."""
    import torch
    from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss

    rendered, vb = model.ray_query(model.ray_test(o, d), **query)
    loss = torch.mean((rendered["rgb_volume"] - torch.abs(d)) ** 2)
    return loss + 0.1 * eikonal_loss(vb["nablas_packed"],
                                     vb["ridx"] < o.shape[0])


def _autograd_nablas(model, x01) -> dict:
    """The nablas by autograd through `forward_sdf` (B1 want_g forward, B2
    with dL/dx backward) against `forward_sdf_nablas` (B3) on the same
    points; returns the launches of the autograd path."""
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
    err = float((nab - ref).abs().max())
    tol = 1e-5 + 1e-4 * float(ref.abs().max())
    print(f"[autograd nablas] {x.shape[0]} points: launches {launches}; "
          f"max|autograd - split| {err:.3e} (tolerance {tol:.3e}: B2's "
          f"dL/dx and B3 sum the same terms in another order)")
    _require(launches == {"brick4_fwd_g": 1, "brick4_bwd": 1},
             "the autograd nablas did not run B1 want_g and B2 once each")
    _require(err <= tol, "autograd and split nablas disagree")
    return launches


def _step_vs_cpu(model, cpu, o, d, cpu_render_s: float) -> None:
    """One step's loss and gradients on the card against the CPU port from
    the same weights and uniforms: the card's draws are recorded and
    replayed on the CPU. The ray count is cut when the CPU step, estimated
    as 3× the CPU render of all rays, would exceed CPU_STEP_BUDGET_S."""
    import torch
    from nr3d_lib_tpu_torch.bridge import to_jax_paths
    from nr3d_lib_tpu_torch.graphics.raysample import uniform_draw

    n = N_RAYS
    while n > 256 and 3.0 * cpu_render_s * n / N_RAYS > CPU_STEP_BUDGET_S:
        n //= 2
    if n < N_RAYS:
        print(f"[step vs cpu] cut to {n} of {N_RAYS} rays: the CPU render of "
              f"{N_RAYS} rays took {cpu_render_s:.1f} s")
    draws, base = [], uniform_draw(
        torch.Generator(device=o.device).manual_seed(8))

    def record(shape, lo, hi):
        draws.append(base(shape, lo, hi))
        return draws[-1]

    def replay(shape, lo, hi):
        u = draws.pop(0).cpu()
        _require(tuple(u.shape) == tuple(shape), "replayed draw shape")
        return u

    model.zero_grad(set_to_none=True)
    cpu.zero_grad(set_to_none=True)
    loss_g = _step_loss(model, o[:n], d[:n], draw=record)
    loss_g.backward()
    t0 = time.perf_counter()
    loss_c = _step_loss(cpu, o[:n].cpu(), d[:n].cpu(), draw=replay)
    loss_c.backward()
    cpu_step_s = time.perf_counter() - t0
    loss_g, loss_c = float(loss_g.detach()), float(loss_c.detach())
    rel_loss = abs(loss_g - loss_c) / abs(loss_c)
    gg = to_jax_paths({k: p.grad for k, p in model.named_parameters()})
    gc = to_jax_paths({k: p.grad for k, p in cpu.named_parameters()})
    errs = {k: float(np.linalg.norm(gg[k] - gc[k]) /
                     max(np.linalg.norm(gc[k]), 1e-12)) for k in gc}
    print(f"[step vs cpu] {n} rays, CPU step {cpu_step_s:.1f} s: loss card "
          f"{loss_g:.7f} cpu {loss_c:.7f}, relative "
          f"{rel_loss:.2e} (tolerance 1e-4); gradients, relative L2 per "
          f"tensor (tolerance 1e-2: the render's discrete choices move a "
          f"few rays whole between routes, and atomics sum in another "
          f"order): max {max(errs.values()):.2e}")
    for k, e in sorted(errs.items()):
        print(f"[step vs cpu]   {k}: {e:.3e}")
    _require(rel_loss <= 1e-4, "card and CPU step losses disagree")
    _require(max(errs.values()) <= 1e-2, "card and CPU gradients disagree")
    model.zero_grad(set_to_none=True)


def _train(model, o, d, smi: str) -> dict:
    """The production train step: warm-up, then N_STEPS timed steps that
    cross an occupancy update. Returns the timed steps' launches."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build

    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    gen = torch.Generator(device=o.device).manual_seed(9)
    its = iter(range(1, 10 ** 6))
    losses = []

    def step():
        it = next(its)
        model.training_before_per_step(it, gen)
        opt.zero_grad(set_to_none=True)
        loss = _step_loss(model, o, d, generator=gen)
        loss.backward()
        opt.step()
        model.training_after_per_step(it, gen)
        losses.append(loss.detach())
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
    print(f"[train] {N_RAYS} rays x {N_STEPS} steps (it {timed[0]}.."
          f"{timed[-1]}) on {smi}: median {med:.3f} ms/step (quartiles "
          f"{q1:.3f}/{q3:.3f}, min {min(times):.3f}, max {max(times):.3f}) "
          f"-> {N_RAYS / med:.1f} Krays/s | peak memory {peak_mib:.1f} MiB")
    print(f"[train] loss per step: {' '.join(f'{v:.6f}' for v in vals)}")
    print(f"[train] launches in the {N_STEPS} timed steps: {launches}")
    n_upd = sum(it % model.lifecycle_update_every == 0 for it in timed)
    expect = {"brick4_fwd": 6 * N_STEPS + n_upd, "brick4_bwd": N_STEPS,
              "brick4_dydx": N_STEPS, "brick4_bwd2": N_STEPS,
              "gather1d": N_STEPS}
    print(f"[train] expected: {expect} (6 B1 per step + 1 at each of the "
          f"{n_upd} occupancy updates)")
    _require(launches == expect, "the train step's launches are not exact")
    _require(all(np.isfinite(vals)), "a loss is not finite")
    last5 = float(np.mean(vals[-5:]))
    print(f"[train] mean loss of the last 5 steps {last5:.6f} vs the first "
          f"step's {vals[0]:.6f}")
    _require(last5 < vals[0], "the loss did not fall")
    _profile(step, med, "train step")
    return launches


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

    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel
    from nr3d_lib_tpu_torch.ops import _build
    from nr3d_lib_tpu_torch.ops import gather1d as G
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4
    from nr3d_lib_tpu_torch.ops import occgrid_march as OM

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

    # ----------------------------------------------------------- model
    model = LoTDNeuSModel(**PROD_CFG, seed=0)
    _set_weights(model, seed=1)
    t0 = time.perf_counter()
    model.populate()
    torch.cuda.synchronize()
    print(f"[populate] occupancy init from the field at 64^3 cell centers: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    occ_np = np.random.default_rng(5).uniform(size=(64, 64, 64)) < 0.15
    model.accel.occ.val_grid.copy_(torch.from_numpy(occ_np.astype(np.float32)))
    enc = model.field.implicit_surface.encoding
    meta = enc.meta
    o_np, d_np = _rays(N_RAYS, seed=0)
    o, d = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)
    kernels = []

    with torch.no_grad():
        table = enc._build_table()
        packed = B4.pack_table4(table)
        table_bytes = packed.numel() * 4
        L = meta.n_levels

        # ------------------------------------------------ B1 brick4_fwd
        x1 = _ray_points(o, d, 144, seed=2)              # 589,824 points
        y_k = B4.brick4_encode(x1, table, meta)
        y_p = B4.brick4_encode_xla(x1, table, meta)
        err = float((y_k - y_p).abs().max())
        tol = 1e-5 + 1e-5 * float(y_p.abs().max())
        print(f"[B1 brick4_fwd] N={x1.shape[0]} L={L}: max|kernel-plain| "
              f"{err:.3e} (tolerance {tol:.3e}: 8-term sums in another "
              f"order)")
        _require(err <= tol, "B1 disagrees with its plain version")
        n = x1.shape[0]
        ms = _time_ms(lambda: B4._fwd_cuda(x1, packed, meta))
        plain_ms = _time_ms(lambda: B4.brick4_encode_xla(x1, table, meta),
                            iters=5)
        # each (point, level): 8 corners × (2 weight muls + 4 FMAs) + 3 axes
        # × 4 (scale, offset, floor, frac) → 92 float ops
        bound_ms, bound_by = _bound(n * (12 + 16 * L) + table_bytes,
                                    n * L * 92)
        print(f"[B1 brick4_fwd] kernel {ms:.4f} ms | plain {plain_ms:.4f} ms"
              f" | bound {bound_ms:.4f} ms ({bound_by}) | library: none")
        kernels.append(dict(
            name="brick4_fwd (B1)", route="cuda",
            source="nr3d_lib_tpu_torch/csrc/brick4.cu",
            replaces="nr3d_lib_tpu/ops/lotd_brick4.py:172",
            key="brick4_fwd", path="render", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))

        # ----------------------------------------------- B3 brick4_dydx
        x3 = _ray_points(o, d, 36, seed=3)               # 147,456 points
        g3 = torch.randn(x3.shape[0], 4 * L, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
        n_k = B4.brick4_nablas(g3, x3, table, meta)
        n_p = B4.brick4_nablas_xla(g3, x3, table, meta)
        err = float((n_k - n_p).abs().max())
        tol = 1e-4 + 1e-4 * float(n_p.abs().max())
        print(f"[B3 brick4_dydx] N={x3.shape[0]}: max|kernel-plain| "
              f"{err:.3e} (tolerance {tol:.3e}: sums over 8 corners × 4 "
              f"feats × {L} levels, scaled by res-2, in another order)")
        _require(err <= tol, "B3 disagrees with its plain version")
        n = x3.shape[0]
        ms = _time_ms(lambda: B4._dydx_cuda(g3, x3, packed, meta))
        plain_ms = _time_ms(lambda: B4.brick4_nablas_xla(g3, x3, table, meta),
                            iters=5)
        # each (point, level): 8 corners × (7 for g·val + 3 axes × 3) +
        # 3 axes × 4 index ops + 3 scale FMAs → 146 float ops
        bound_ms, bound_by = _bound(n * (12 + 16 * L + 12) + table_bytes,
                                    n * L * 146)
        print(f"[B3 brick4_dydx] kernel {ms:.4f} ms | plain {plain_ms:.4f} "
              f"ms | bound {bound_ms:.4f} ms ({bound_by}) | library: none")
        kernels.append(dict(
            name="brick4_dydx (B3)", route="cuda",
            source="nr3d_lib_tpu_torch/csrc/brick4.cu",
            replaces="nr3d_lib_tpu/ops/lotd_brick4.py:803",
            key="brick4_dydx", path="render", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))

        # ---------------------------------------------------- B5 gather1d
        rt = model.ray_test(o, d)
        o_n, d_n = model.space.normalize_rays(o, d)
        t5, _, _ = OM.march_steps(rt["near"], rt["far"], 96, 2.0 / 96)
        xs = [o_n[:, None, a] + d_n[:, None, a] * t5 for a in range(3)]
        row, lane, _ = OM.grid_rows_lanes((64, 64, 64), *xs)
        row, lane = row.reshape(-1).contiguous(), lane.reshape(-1).contiguous()
        values = model.accel.occ.occ().reshape(4096, 64).to(torch.float32)
        v_k = G.gather_rows_lanes(values, row, lane)
        v_p = G.gather_rows_lanes_plain(values, row, lane)
        err = float((v_k - v_p).abs().max())
        print(f"[B5 gather1d] N={row.numel()} table {tuple(values.shape)}: "
              f"max|kernel-plain| {err:.3e} (tolerance 0: a copy)")
        _require(err == 0.0, "B5 disagrees with its plain version")
        n = row.numel()
        ms = _time_ms(lambda: G.gather_rows_lanes(values, row, lane))
        plain_ms = _time_ms(
            lambda: G.gather_rows_lanes_plain(values, row, lane))
        rl, ll = row.long(), lane.long()
        library_ms = _time_ms(lambda: values[rl, ll])
        bound_ms, bound_by = _bound(n * 12 + values.numel() * 4, 0)
        print(f"[B5 gather1d] kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
              f"values[row, lane] {library_ms:.4f} ms | bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        kernels.append(dict(
            name="gather1d (B5)", route="cuda",
            source="nr3d_lib_tpu_torch/csrc/gather1d.cu",
            replaces="nr3d_lib_tpu/ops/gather1d.py:30",
            key="gather1d", path="render", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))

        # ------------------------ training kernels at the step's 147,456 points
        n = x3.shape[0]
        gen_k = torch.Generator(device=dev).manual_seed(6)
        g2 = torch.randn(n, 4 * L, device=dev, generator=gen_k)
        gg4 = torch.randn(n, 3, device=dev, generator=gen_k)
        dtab_bytes = meta.total_rows * 256 * 4       # the zeroed f32 output

        # B1 with want_g: y and the corner words B2 reads back for dL/dx
        y_k, words = B4._fwd_cuda(x3, packed, meta, want_g=True)
        y_p = B4.brick4_encode_xla(x3, table, meta)
        err = float((y_k - y_p).abs().max())
        tol = 1e-5 + 1e-5 * float(y_p.abs().max())
        words_ok = bool(torch.equal(words,
                                    B4.brick4_corner_words_xla(x3, table,
                                                               meta)))
        print(f"[B1 want_g brick4_fwd_g] N={n}: max|kernel-plain| {err:.3e} "
              f"(tolerance {tol:.3e}, as B1); corner words equal: "
              f"{words_ok} (tolerance 0: a copy)")
        _require(err <= tol and words_ok,
                 "B1 want_g disagrees with its plain version")
        ms = _time_ms(lambda: B4._fwd_cuda(x3, packed, meta, want_g=True))
        plain_ms = _time_ms(lambda: (
            B4.brick4_encode_xla(x3, table, meta),
            B4.brick4_corner_words_xla(x3, table, meta)), iters=5)
        # B1's bytes and operations plus 8 corners × 8 B of words per level
        bound_ms, bound_by = _bound(n * (12 + 16 * L + 64 * L) + table_bytes,
                                    n * L * 92)
        print(f"[B1 want_g brick4_fwd_g] kernel {ms:.4f} ms | plain "
              f"{plain_ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}) | "
              f"library: none")
        kernels.append(dict(
            name="brick4_fwd want_g (B1)", route="cuda",
            source="nr3d_lib_tpu_torch/csrc/brick4.cu",
            replaces="nr3d_lib_tpu/ops/lotd_brick4.py:172",
            key="brick4_fwd_g", path="autograd nablas", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))

        # B2: dL/dtable by float4 atomics; dL/dx from the want_g words
        dx_p, dtab_p = B4.brick4_encode_bwd_xla(x3, table, g2, meta, True)
        _, dtab_k = B4._bwd_cuda(x3, g2, meta, need_dx=False)
        dx_k, dtab_k2 = B4._bwd_cuda(x3, g2, meta, need_dx=True, words=words)
        err_t = max(float((dtab_k - dtab_p).abs().max()),
                    float((dtab_k2 - dtab_p).abs().max()))
        tol_t = 1e-6 + 1e-5 * float(dtab_p.abs().max())
        err_x = float((dx_k - dx_p).abs().max())
        tol_x = 1e-4 + 1e-4 * float(dx_p.abs().max())
        print(f"[B2 brick4_bwd] N={n}: max|kernel-plain| dL/dtable "
              f"{err_t:.3e} (tolerance {tol_t:.3e}: ~150 terms per dense "
              f"slot summed by atomics in an order that changes from run to "
              f"run), dL/dx {err_x:.3e} (tolerance {tol_x:.3e}: sums over "
              f"corners, feats and levels scaled by res-2)")
        _require(err_t <= tol_t and err_x <= tol_x,
                 "B2 disagrees with its plain version")
        ms = _time_ms(lambda: B4._bwd_cuda(x3, g2, meta, need_dx=False))
        ms_dx = _time_ms(lambda: B4._bwd_cuda(x3, g2, meta, need_dx=True,
                                              words=words))
        plain_ms = _time_ms(lambda: B4.brick4_encode_bwd_xla(
            x3, table, g2, meta, False), iters=5)
        plain_ms_dx = _time_ms(lambda: B4.brick4_encode_bwd_xla(
            x3, table, g2, meta, True), iters=5)
        # each (point, level): 12 index ops + 8 corners × (2 weight muls +
        # 4 products + 4 adds) = 92; with dL/dx + 8 × (7 for g·val + 9)
        bound_ms, bound_by = _bound(n * (12 + 16 * L) + dtab_bytes,
                                    n * L * 92)
        bound_dx, bound_dx_by = _bound(
            n * (12 + 16 * L + 64 * L + 12) + dtab_bytes, n * L * (92 + 128))
        print(f"[B2 brick4_bwd] need_dx false (the step's form): kernel "
              f"{ms:.4f} ms | plain {plain_ms:.4f} ms | bound {bound_ms:.4f}"
              f" ms ({bound_by}); need_dx true: kernel {ms_dx:.4f} ms | "
              f"plain {plain_ms_dx:.4f} ms | bound {bound_dx:.4f} ms "
              f"({bound_dx_by}) | library: none")
        kernels.append(dict(
            name="brick4_bwd (B2)", route="cuda",
            source="nr3d_lib_tpu_torch/csrc/brick4.cu",
            replaces="nr3d_lib_tpu/ops/lotd_brick4.py:380",
            key="brick4_bwd", path="train step", max_abs_err=max(err_t, err_x),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, ms_need_dx=ms_dx, plain_ms_need_dx=plain_ms_dx,
            bound_ms_need_dx=bound_dx))

        # B4: the nablas' backward
        dg_p, dx4_p, dt4_p = B4.brick4_nablas_bwd_xla(g2, x3, table, gg4,
                                                      meta)
        dg_k, dx4_k, dt4_k = B4._bwd2_cuda(g2, x3, packed, gg4, meta)
        _, none_dx, dt4_k2 = B4._bwd2_cuda(g2, x3, packed, gg4, meta,
                                           need_dx=False)
        _require(none_dx is None, "B4 wrote dL/dx without need_dx")
        e_g = float((dg_k - dg_p).abs().max())
        e_x = float((dx4_k - dx4_p).abs().max())
        e_t = max(float((dt4_k - dt4_p).abs().max()),
                  float((dt4_k2 - dt4_p).abs().max()))
        t_g = 1e-4 + 1e-4 * float(dg_p.abs().max())
        t_x = 1e-4 + 1e-4 * float(dx4_p.abs().max())
        t_t = 1e-6 + 1e-5 * float(dt4_p.abs().max())
        print(f"[B4 brick4_bwd2] N={n}: max|kernel-plain| dL/dg_up {e_g:.3e}"
              f" (tolerance {t_g:.3e}), dL/dx {e_x:.3e} (tolerance "
              f"{t_x:.3e}): sums over corners scaled by (res-2)^2 in "
              f"another order; dL/dtable {e_t:.3e} (tolerance {t_t:.3e}: "
              f"atomics, order changes from run to run)")
        _require(e_g <= t_g and e_x <= t_x and e_t <= t_t,
                 "B4 disagrees with its plain version")
        ms = _time_ms(lambda: B4._bwd2_cuda(g2, x3, packed, gg4, meta,
                                            need_dx=False))
        ms_dx = _time_ms(lambda: B4._bwd2_cuda(g2, x3, packed, gg4, meta))
        plain_ms = _time_ms(lambda: B4.brick4_nablas_bwd_xla(
            g2, x3, table, gg4, meta), iters=5)
        # each (point, level): 18 index/scale ops + 8 corners × (11 for c_k
        # + 8 for dL/dg_up + 8 for dL/dtable) = 234; dL/dx + 8 × 25
        io = n * (16 * L + 12 + 12 + 16 * L) + table_bytes + dtab_bytes
        bound_ms, bound_by = _bound(io, n * L * 234)
        bound_dx, bound_dx_by = _bound(io + n * 12, n * L * 434)
        print(f"[B4 brick4_bwd2] need_dx false (the step's form): kernel "
              f"{ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}); need_dx "
              f"true: kernel {ms_dx:.4f} ms | bound {bound_dx:.4f} ms "
              f"({bound_dx_by}); plain (all three gradients) {plain_ms:.4f}"
              f" ms | library: none")
        kernels.append(dict(
            name="brick4_bwd2 (B4)", route="cuda",
            source="nr3d_lib_tpu_torch/csrc/brick4.cu",
            replaces="nr3d_lib_tpu/ops/lotd_brick4.py:875",
            key="brick4_bwd2", path="train step",
            max_abs_err=max(e_g, e_x, e_t), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            ms_need_dx=ms_dx, bound_ms_need_dx=bound_dx))

        # ---------------------------------------------------- the slice
        def render():
            rendered, vb = model.ray_query(model.ray_test(o, d))
            return rendered, vb

        render()                                            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        times = []
        for _ in range(N_RENDERS):
            t0 = time.perf_counter()
            rendered, vb = render()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.LAUNCHES)
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        med = statistics.median(times)
        q1, _, q3 = statistics.quantiles(times, n=4)
        print(f"[slice] {N_RAYS} rays x {N_RENDERS} renders on {smi}: "
              f"median {med:.3f} ms/render (quartiles {q1:.3f}/{q3:.3f}, "
              f"min {min(times):.3f}, max {max(times):.3f}) -> "
              f"{N_RAYS / med:.1f} Krays/s | peak memory {peak_mib:.1f} MiB"
              f" | n_compact {int(vb['n_compact'])} of "
              f"{vb['valid'].numel()} slots")
        print(f"[slice] launches in the {N_RENDERS} timed renders: "
              f"{launches}")
        expect = {"brick4_fwd": 6, "brick4_dydx": 1, "gather1d": 1}
        for key, per in expect.items():
            got = launches.get(key, 0)
            _require(got == per * N_RENDERS,
                     f"{key}: {got} launches, expected {per} per render")
        for k, v in rendered.items():
            _require(bool(torch.isfinite(v).all()), f"{k} is not finite")
        mask_mean = float(rendered["mask_volume"].mean())
        print(f"[slice] all outputs finite; mean mask_volume {mask_mean:.4f}")
        _require(mask_mean > 0.1, "the render is trivially empty")
        _profile(render, med)
        path_launches = {"render": (launches, N_RENDERS)}

        # same rays, same weights, the CPU port (plain versions)
        cpu = LoTDNeuSModel(**PROD_CFG, seed=0, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        t0 = time.perf_counter()
        r_cpu, _ = cpu.ray_query(cpu.ray_test(o.cpu(), d.cpu()))
        cpu_s = time.perf_counter() - t0
        ok = torch.ones(N_RAYS, dtype=torch.bool)
        errs = []
        for k in ("rgb_volume", "depth_volume"):
            e = (rendered[k].cpu() - r_cpu[k]).abs().reshape(N_RAYS, -1)
            e = e.amax(-1)
            errs.append(e)
            ok &= e <= 1e-4
        e_max = torch.stack(errs).amax(0)
        share = float(ok.float().mean())
        print(f"[slice] GPU vs CPU port ({cpu_s:.1f} s on the CPU): "
              f"{share * 100:.2f}% of rays agree within 1e-4 on rgb and "
              f"depth ({float((e_max <= 1e-3).float().mean()) * 100:.2f}% "
              f"within 1e-3; max {float(e_max.max()):.3e})")
        _require(share >= 0.99, "GPU and CPU renders disagree")

    path_launches["autograd nablas"] = (_autograd_nablas(model, x3), 1)
    _step_vs_cpu(model, cpu, o, d, cpu_s)
    path_launches["train step"] = (_train(model, o, d, smi), N_STEPS)

    for kd in kernels:
        got, calls = path_launches[kd["path"]]
        kd["launches"] = got.get(kd.pop("key"), 0)
        kd["launches_per_call"] = kd["launches"] / calls
        _require(kd["launches"] > 0, f"{kd['name']}: no launch on its path")
    print(json.dumps({"kernels": kernels}))
    print(f"[device] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
