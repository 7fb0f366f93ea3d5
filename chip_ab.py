#!/usr/bin/env python3
"""Time the parent commit's B7 and B17 kernels against this tree's, in
turns, on one card, with probes, and compare their outputs: the F=2
brick encode's backward B7 (`brick_bwd`, `csrc/brick.cu`) and the
gaussian blend B17 (`gs_blend`, `csrc/gaussian_blend.cu`).

    git archive <parent> nr3d_lib_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_ab.py _archive/parent/nr3d_lib_tpu_torch/csrc

(`_archive/` is listed in `.gitignore`; run the second line where the
card is.) Builds, with the port's nvcc flags, into `_archive/ab_build/`,
one nvcc per library, all started together, each source with its own
directory's headers (`-I`): the parent's and this tree's `brick.cu` and
`gaussian_blend.cu`, and probes made by text substitution, in lieu of
`ncu`:

- `brick_noatomics`: this tree's `warp_add2` (`warp_atomics.cuh`) sends
  each sum to a register sink that is never stored (wrong table
  gradients: the atomics' and the aggregation's cost);
- `brick_lane_atomics`: `warp_add2` issues one atomic per lane (the
  aggregation off: the parent's atomics in this tree's warps);
- `brick_parent_noatomics`: the parent's B7 without its atomics;
- `gs_nocull`: this tree's B17 with its cull's test computed and its
  result forced false (every slot walked: the cost of the boxes, the
  tests and the masks);
- `gs_count`: this tree's B17 adding 1 to acc for each slot a warp walks
  (its acc is the count of its warp's kept slots);
- `gs_scalar_loads`: this tree's B17 reading a kept slot's record with
  11 scalar (volatile) shared loads, not three 16-byte ones.

Prints each library's ptxas registers, the SASS instruction counts of
the two kernels and the instructions a pair of B17's walk (its innermost
loop around the `MUFU.EX2` of the expf, over the pairs it evaluates),
then, with the tolerances of `chip_smoke.py`:

- B7 at the F=2 NeuS train step's shape, 147,456 points along rays × 4
  levels (9,648 rows), ray order and randomly permuted: dL/dtable and
  dL/dx against the plain version, dL/dx bitwise equal in two runs and
  between the orders, dL/dtable's distance to a float64 sum of the same
  contributions (the plain version's and three runs each of the
  parent's, the new and the one-atomic-a-lane kernels'), the float2
  atomics issued (`ops/lotd_brick.brick_atomic_groups`), times in turns
  (parent, new, probes, probes reversed, new, parent) without dL/dx (the
  step's form) and, parent and new, with it;
- B7 on the step's own inputs: the points and upstream gradients that
  B7 receives inside the F=2 NeuS train step, recorded by a wrapper
  around `_bwd_cuda` (`chip_smoke._record_b7`) at two steps of one run
  of `chip_smoke.py`'s train step from its seeded weights: it = 4 (after
  three steps) and the step that `chip_smoke.py` itself records, it = 23
  (after its 2 warm-up and 20 timed steps, across the occupancy update
  at it = 16). At each: the points as recorded and permuted, the atomics
  both need, times alone in turns, and B7's device time inside that
  step (torch.profiler over three of its forward-backward passes, B7's
  wrapper routed to the parent's or the new library, in turns);
- B17 at the bench scene's own per-tile attrs (`GS._tile_attrs` at
  500,000 gaussians, 512², tile 16, capacity 256; and the same scene in
  8² tiles, 64 tiles a gaussian) and on tiles whose
  slots lie within ulps of the α floor
  (`tests/torch_gs_tiles.near_floor_tiles`): rgb, acc and depth of the
  new kernel and of its probes bitwise equal to the parent's, the (warp,
  slot) pairs the cull keeps (the `gs_count` probe, and the plain mirror
  `gs_blend_cull_plain`) against those some pixel takes and the live
  ones, times in turns; B18 (`gs_blend_bwd`, whose source changed only
  in how `alpha_of` is written) bitwise equal to the parent's at the
  bench scene, parent and new timed in turns.

The last line of its output is one JSON object with every number. It
exits 1 if a comparison failed (the JSON's "failed" names it).
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BUILD = REPO / "_archive" / "ab_build"
NEW = REPO / "nr3d_lib_tpu_torch" / "csrc"

# the body of warp_add2, from its first line to its last
AGG_FIRST = "  const unsigned peers = __match_any_sync(active, key);"
AGG_LAST = "  if (below == 0u) atomic_add2(dst + key, v);"
NO_ATOMICS = "  if (v.x == 1.0e38f && v.y == -1.0e38f) atomic_add2(dst + key, v);"
LANE_ATOMICS = "  atomic_add2(dst + key, v);"
# the parent's B7: its atomic
PARENT_B7_ATOMIC = \
    "    atomic_add2(dtab + base + off, make_float2(w * gv.x, w * gv.y));"
PARENT_B7_SINK = ("    if (w == 1.0e38f && gv.x == -1.0e38f) "
                  "atomic_add2(dtab + base + off, make_float2(w, gv.y));")
# this tree's B17: the cull's verdict, and its first sum
GS_CUT = "            sb.mode == 1 || (sb.mode == 2 && cull_test(sb, box[w]));"
GS_NO_CUT = ("            (sb.mode == 1 || (sb.mode == 2 && cull_test(sb, "
             "box[w]))) &\n            (afloor < -1.0f);")
GS_SUM = "        acc += vw;\n        r += vw * q1.z;"
GS_COUNT = "        acc += 1.0f;\n        r += vw * q1.z;"
# this tree's B17: a kept slot's record, read by three 16-byte loads
GS_RECORD = """        const float4 q0 = s[REC * j], q1 = s[REC * j + 1],
                     q2 = s[REC * j + 2];"""
GS_SCALAR = """        const volatile float* fj =
            reinterpret_cast<const volatile float*>(s + REC * j);
        const float4 q0 = make_float4(fj[0], fj[1], fj[2], fj[3]),
                     q1 = make_float4(fj[4], fj[5], fj[6], fj[7]),
                     q2 = make_float4(fj[8], fj[9], fj[10], 0.0f);"""
NEUS_F2_META = ([16, 32, 64, 128], ["Dense", "Dense", "Hash", "Hash"], 4096)
GS_FLOOR = 1.0 / 255.0


def _probe(name: str, tree: Path, target: str, old: str, new: str,
           src: str) -> tuple:
    """A copy of the sources `tree` in BUILD/name with `old` replaced by
    `new` in the file `target`; (the copy's `src`, its -I dir)."""
    out = BUILD / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(tree, out)
    text = (out / target).read_text()
    if old not in text:
        raise RuntimeError(f"{target}: the text {name} replaces is not in "
                           f"it")
    (out / target).write_text(text.replace(old, new, 1))
    return out / src, out


def _agg_body() -> str:
    text = (NEW / "warp_atomics.cuh").read_text()
    a, b = text.index(AGG_FIRST), text.index(AGG_LAST) + len(AGG_LAST)
    return text[a:b]


def _nvcc_all(sources: dict) -> None:
    """One nvcc per library, all started together; prints ptxas'
    registers of B7's and B17's kernels."""
    from nr3d_lib_tpu_torch.ops import _build as B

    procs = {}
    for name, (src, inc) in sources.items():
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-I", str(inc), "-o",
               str(BUILD / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        entry = ""
        for line in text.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line and _ours(entry):
                print(f"[ptxas {name}] {entry[:60]}: {line.strip()}")


def _ours(kernel: str) -> bool:
    return any(k in kernel for k in ("brick_bwd_kernel", "gs_blend_kernel"))


def _build() -> dict:
    parent = Path(sys.argv[1]).resolve()
    BUILD.mkdir(parents=True, exist_ok=True)
    body = _agg_body()
    sources = {
        "brick_parent": (parent / "brick.cu", parent),
        "brick_new": (NEW / "brick.cu", NEW),
        "brick_noatomics": _probe("brick_noatomics", NEW,
                                  "warp_atomics.cuh", body, NO_ATOMICS,
                                  "brick.cu"),
        "brick_lane_atomics": _probe("brick_lane_atomics", NEW,
                                     "warp_atomics.cuh", body, LANE_ATOMICS,
                                     "brick.cu"),
        "brick_parent_noatomics": _probe(
            "brick_parent_noatomics", parent, "brick.cu", PARENT_B7_ATOMIC,
            PARENT_B7_SINK, "brick.cu"),
        "gs_parent": (parent / "gaussian_blend.cu", parent),
        "gs_new": (NEW / "gaussian_blend.cu", NEW),
        "gs_nocull": _probe("gs_nocull", NEW, "gaussian_blend.cu", GS_CUT,
                            GS_NO_CUT, "gaussian_blend.cu"),
        "gs_count": _probe("gs_count", NEW, "gaussian_blend.cu", GS_SUM,
                           GS_COUNT, "gaussian_blend.cu"),
        "gs_scalar_loads": _probe("gs_scalar_loads", NEW, "gaussian_blend.cu",
                                  GS_RECORD, GS_SCALAR, "gaussian_blend.cu"),
    }
    _nvcc_all(sources)
    return {name: BUILD / f"lib{name}.so" for name in sources}


def _load(path: Path) -> ctypes.CDLL:
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    vp, n = ctypes.c_void_p, ctypes.c_longlong
    ci, cf = ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(path))
    if hasattr(lib, "brick_bwd"):
        sigs = {"brick_bwd": [vp, vp, vp, vp, B._Meta, vp, vp, n, vp]}
    else:
        sigs = {"gs_blend": [vp, vp, vp, vp, vp, ci, ci, ci, cf, cf, cf, cf,
                             vp],
                "gs_blend_bwd": [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, cf,
                                 cf, cf, cf, vp]}
    for fn, types in sigs.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _turns(fns: dict, order) -> dict:
    import chip_smoke as CS

    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(CS._time_ms(fns[k]))
    return ms


def _bwd(lib, dev, x, g, meta, need_dx, corners=None):
    """B7 of one library → (dL/dx or None, dL/dtable)."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    dtab = torch.empty(meta.total_rows, 128, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    Bu.check(lib.brick_bwd(x.data_ptr(), g.data_ptr(),
                           corners.data_ptr() if need_dx else None, None,
                           B.c_meta(meta), dtab.data_ptr(),
                           dx.data_ptr() if need_dx else None, x.shape[0],
                           Bu.stream_ptr(dev)), "brick_bwd")
    return dx, dtab


def _blend(lib, attrs, origin, tile):
    """B17 of one library → (rgb, acc, depth)."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu

    n_t, _, k = attrs.shape
    p = tile * tile
    rgb = torch.empty(n_t, p, 3, device=attrs.device)
    acc = torch.empty(n_t, p, device=attrs.device)
    dep = torch.empty(n_t, p, device=attrs.device)
    Bu.check(lib.gs_blend(attrs.data_ptr(), origin.data_ptr(),
                          rgb.data_ptr(), acc.data_ptr(), dep.data_ptr(), n_t,
                          k, tile, 0.0, 0.0, 0.0, GS_FLOOR,
                          Bu.stream_ptr(attrs.device)), "gs_blend")
    return rgb, acc, dep


def _blend_bwd(lib, attrs, origin, g, tile):
    """B18 of one library → the slot gradients [T, 11, K]."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu

    n_t, _, k = attrs.shape
    threads = -(-tile * tile // 32) * 32
    dattrs = torch.empty_like(attrs)
    ckpt = torch.empty(n_t * -(-k // 16) * threads, device=attrs.device)
    Bu.check(lib.gs_blend_bwd(attrs.data_ptr(), origin.data_ptr(),
                              *(t.data_ptr() for t in g), dattrs.data_ptr(),
                              ckpt.data_ptr(), n_t, k, tile, 0.0, 0.0, 0.0,
                              GS_FLOOR, Bu.stream_ptr(attrs.device)),
             "gs_blend_bwd")
    return dattrs


def _rays(dev):
    import torch
    import chip_smoke as CS

    return (torch.from_numpy(a).to(dev) for a in CS._rays(CS.N_RAYS, seed=0))


def _f64_dist(dtabs, ref) -> list:
    return [float((t.double().view(ref.shape) - ref).abs().max())
            for t in dtabs]


def _steps(dev, its: tuple):
    """`chip_smoke.py`'s path B model from its seeded weights and
    occupancy, trained by its train step (`chip_smoke._train_step`);
    yields (it, model, rays) just before each train step `it` in `its`."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    o, d = _rays(dev)
    m = LoTDNeuSModel(**CS.NEUS_F2_CFG, seed=0)
    CS._seed_weights(m, m.field.implicit_surface.encoding, 3)
    m.populate()
    CS._seed_occupancy(m)
    opt, gen = CS._train_state(m, dev)
    for it in range(1, max(its) + 1):
        if it in its:
            yield it, m, (o, d)
        with torch.enable_grad():
            CS._train_step(m, opt, gen, o, d, it)


def _in_step_ms(libs: dict, dev, model, rays, it: int, names) -> dict:
    """B7's device time inside train step `it` (its forward and backward,
    no optimizer step, the generator seeded as `chip_smoke._record_b7`
    seeds it), with B7's wrapper routed to each library in `names`, in
    turns: ms per pass over three passes (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    orig, out = B._bwd_cuda, {}

    def one(name):
        def via(x, g, meta, *, need_dx, corners=None, table=None):
            if need_dx:
                raise RuntimeError("the step's B7 runs without dL/dx")
            return _bwd(libs[name], dev, B.aligned(x), B.aligned(g), meta,
                        False)
        B._bwd_cuda = via
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    gen = torch.Generator(device=dev).manual_seed(9)
                    model.training_before_per_step(it, gen)
                    CS._step_loss(model, *rays, generator=gen).backward()
                    model.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
        finally:
            B._bwd_cuda = orig
        ms = [getattr(ev, "self_device_time_total", 0.0) / 3e3
              for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and "brick_bwd_kernel" in ev.key]
        if not ms:
            raise RuntimeError("no brick_bwd_kernel in the step's profile")
        out.setdefault(name, []).append(sum(ms))

    for name in tuple(names) + tuple(names)[::-1]:
        one(name)
    return out


def _brick(libs: dict, dev) -> dict:
    """B7 at the F=2 NeuS train step's shape, and on the step's own
    inputs."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    o, d = _rays(dev)
    meta = B.make_brick_meta(*NEUS_F2_META)
    x = CS._ray_points(o, d, 36, seed=14)
    n, L = x.shape[0], meta.n_levels
    table = torch.from_numpy(np.random.default_rng(15).uniform(
        -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(dev)
    gen = torch.Generator(dev).manual_seed(16)
    g = torch.randn(n, 2 * L, device=dev, generator=gen)
    perm = torch.randperm(n, device=dev,
                          generator=torch.Generator(dev).manual_seed(5))
    res = {"n": n, "rows": meta.total_rows, "atomics_naive": n * L * 8}

    def run(m, x_, g_, need_dx=False, corners=None):
        return _bwd(libs[m], dev, x_, g_, meta, need_dx, corners)

    with torch.no_grad():
        # dL/dtable in float64 from the same float32 cell fractions
        ref = torch.zeros(meta.total_rows * 64, 2, dtype=torch.float64,
                          device=dev)
        bits = B._corner_bits(dev)
        offs = (bits[:, 0] * 4 + bits[:, 1]) * 4 + bits[:, 2]
        for l, lv in enumerate(meta.levels):
            row, lane0, frac = B._level_rows_and_lanes(x, lv)
            f = frac.double()[:, None, :]
            w = (f * bits + (1.0 - f) * (1.0 - bits)).prod(-1)        # [N,8]
            slot = row[:, None] * 64 + lane0[:, None] // 2 + offs
            ref.index_add_(0, slot.reshape(-1), (
                w[..., None] * g[:, None, 2 * l:2 * l + 2].double())
                .reshape(-1, 2))
        _, dt_p = B.brick_encode_bwd_xla(x, table, g, meta, False)
        res["dtab_vs_f64"] = {"plain": _f64_dist([dt_p], ref)[0]}
        for m in ("brick_parent", "brick_new", "brick_lane_atomics"):
            res["dtab_vs_f64"][m] = _f64_dist(
                [run(m, x, g)[1] for _ in range(3)], ref)
        del ref
        names = ("brick_parent", "brick_new", "brick_noatomics",
                 "brick_lane_atomics", "brick_parent_noatomics")
        two = ("brick_parent", "brick_new")
        dxs = {}
        for order, xx, gg in (("ray", x, g),
                              ("permuted", x[perm].contiguous(),
                               g[perm].contiguous())):
            groups = B.brick_atomic_groups(xx, meta)
            res[f"{order}_atomic_groups"] = sum(groups)
            res[f"{order}_atomic_groups_by_level"] = groups
            corners = B._fwd_cuda(xx, table, meta, want_g=True)[1]
            dx_p, dt_p = B.brick_encode_bwd_xla(xx, table, gg, meta, True)
            dx, dtab = run("brick_new", xx, gg, True, corners)
            dx_par, _ = run("brick_parent", xx, gg, True, corners)
            dxs[order] = dx
            key = f"b7_{order}"
            res[f"{key}_dtab_err"] = float((dtab - dt_p).abs().max())
            res[f"{key}_dtab_tol"] = 1e-6 + 1e-5 * float(dt_p.abs().max())
            res[f"{key}_lane_atomics_dtab_err"] = float(
                (run("brick_lane_atomics", xx, gg)[1] - dt_p).abs().max())
            res[f"{key}_dx_err"] = float((dx - dx_p).abs().max())
            res[f"{key}_dx_tol"] = 1e-4 + 1e-4 * float(dx_p.abs().max())
            res[f"{key}_parent_dx_err"] = float((dx_par - dx_p).abs().max())
            res[f"{key}_dx_max_diff_vs_parent"] = float(
                (dx - dx_par).abs().max())
            res[f"{key}_dx_bitwise_between_runs"] = bool(torch.equal(
                dx, run("brick_new", xx, gg, True, corners)[0]))
            res[f"{key}_ms"] = _turns(
                {m: (lambda m=m, a=(xx, gg): run(m, *a)) for m in names},
                names + names[::-1])
            res[f"{key}_need_dx_ms"] = _turns(
                {m: (lambda m=m, a=(xx, gg, True, corners): run(m, *a))
                 for m in two}, two + two[::-1])
        res["b7_dx_bitwise_between_orders"] = bool(torch.equal(
            dxs["permuted"][torch.argsort(perm)], dxs["ray"]))

        # the step's own inputs at it = 4 and at the smoke's step, each as
        # recorded and permuted; B7 inside each step
        smoke_it = CS.N_WARMUP_STEPS + CS.N_STEPS + 1
        for it, model, rays in _steps(dev, (4, smoke_it)):
            key = f"step_it{it}"
            with torch.enable_grad():
                rec = CS._record_b7(model, *rays, it=it)
                res[f"{key}_in_step_ms"] = _in_step_ms(libs, dev, model,
                                                       rays, it, two)
            _step_points(libs, dev, rec, key, names, two, res)
    return res


def _step_points(libs, dev, rec, key, names, two, res) -> None:
    """B7 alone on one step's recorded inputs (as recorded and permuted):
    atomics, times in turns, times with a cold L2, dL/dtable against the
    plain version; into `res` under `key`."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    xs, gs, kw, meta = rec["x"], rec["g"], rec["kw"], rec["meta"]
    ns = xs.shape[0]
    res[f"{key}_n"] = ns
    res[f"{key}_kw"] = {k: (v if isinstance(v, bool) else v is not None)
                        for k, v in kw.items()}
    res[f"{key}_atomics_naive"] = ns * meta.n_levels * 8
    ps = torch.randperm(ns, device=dev,
                        generator=torch.Generator(dev).manual_seed(6))
    for order, xx, gg in (("ray", xs, gs),
                          ("permuted", xs[ps].contiguous(),
                           gs[ps].contiguous())):
        groups = B.brick_atomic_groups(xx, meta)
        res[f"{key}_{order}_atomic_groups"] = sum(groups)
        res[f"{key}_{order}_atomic_groups_by_level"] = groups
        res[f"{key}_{order}_ms"] = _turns(
            {m: (lambda m=m, a=(xx, gg): _bwd(
                libs[m], dev, *a, meta, False)) for m in names},
            names + names[::-1])
    # the same, each launch after 128 MB written (the 50 MB L2 holds none
    # of B7's inputs or of its gradient table then), less the writes' own
    # time
    junk = torch.empty(32 * 2 ** 20, device=dev)
    flush = CS._time_ms(lambda: junk.fill_(1.0))
    res[f"{key}_ray_flush_ms"] = flush
    res[f"{key}_ray_cold_l2_ms"] = {
        m: [v - flush for v in vs] for m, vs in _turns(
            {m: (lambda m=m: (junk.fill_(1.0), _bwd(
                libs[m], dev, xs, gs, meta, False)))
             for m in two}, two + two[::-1]).items()}
    del junk
    zeros = torch.zeros(meta.total_rows, 128, device=dev)
    _, dt_p = B.brick_encode_bwd_xla(xs, zeros, gs, meta, False)
    dtab = _bwd(libs["brick_new"], dev, xs, gs, meta, False)[1]
    res[f"b7_{key}_dtab_err"] = float((dtab - dt_p).abs().max())
    res[f"b7_{key}_dtab_tol"] = 1e-6 + 1e-5 * float(dt_p.abs().max())


def _gs(libs: dict, dev) -> dict:
    """B17 at the bench scene's tiles, and on near-floor tiles."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch import bridge
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    sys.path.insert(0, str(REPO / "tests"))
    from torch_gs_tiles import near_floor_tiles

    tile = CS.GS_CFG["tile"]
    p = bridge.gaussians_from_jax(CS._gs_params(CS.GS_N, seed=21),
                                  device=dev)
    res = {}
    names = ("gs_parent", "gs_new", "gs_nocull", "gs_scalar_loads")
    with torch.no_grad():
        attrs, origin, _, _ = GS._tile_attrs(
            p["means"], p["scales"], p["quats"], p["opac"], p["cols"],
            *CS._gs_camera(dev), CS.GS_HW, **CS.GS_CFG)
        # the same scene cut into 8² tiles (each gaussian's area in 4x the
        # tiles), for B17 at 2 warps a block over a full scene
        a8, o8, _, _ = GS._tile_attrs(
            p["means"], p["scales"], p["quats"], p["opac"], p["cols"],
            *CS._gs_camera(dev), CS.GS_HW, tile=8, tiles_per_gaussian=64,
            tile_capacity=CS.GS_CFG["tile_capacity"])
        cases = {"bench": (attrs, origin, tile), "bench_tile8": (a8, o8, 8)}
        for t in (8, 16):
            a, o, _ = near_floor_tiles(dev, 64, 256, t, seed=40 + t)
            cases[f"near_floor_{t}"] = (a, o, t)
        for what, (a, o, t) in cases.items():
            outs = {m: _blend(libs[m], a, o, t) for m in names}
            for m in names[1:]:
                res[f"b17_{what}_{m}_bitwise_vs_parent"] = all(
                    torch.equal(u, v) for u, v in zip(outs[m],
                                                      outs["gs_parent"]))
            live = GS._alpha_parts(a, o, t, GS_FLOOR)[5]          # [T,P,K]
            wp = GS._warp_pixels(t).to(dev)
            n_t, k = a.shape[0], a.shape[2]
            taken = (live[:, wp.clamp(min=0).view(-1)].view(
                n_t, *wp.shape, k) & (wp >= 0)[None, :, :, None]).any(2)
            del live
            keep = GS.gs_blend_cull_plain(a, o, t, GS_FLOOR)
            counted = _blend(libs["gs_count"], a, o, t)[1]        # [T, P]
            kept = int(sum(float(counted[:, int(w[0])].sum())
                           for w in wp.cpu()))
            res[f"b17_{what}_pairs"] = n_t * wp.shape[0] * k
            res[f"b17_{what}_live_pairs"] = int(
                (a[:, 10] > 0).sum()) * wp.shape[0]
            res[f"b17_{what}_taken_pairs"] = int(taken.sum())
            res[f"b17_{what}_kept_pairs"] = kept
            res[f"b17_{what}_mirror_kept_pairs"] = int(keep.sum())
            res[f"b17_{what}_mirror_keeps_every_taken_pair"] = not bool(
                (taken & ~keep).any())
            # the work per tile (kept pairs), and per SM if block i ran on
            # SM i mod n_sm (all tiles fit in one wave there)
            per_tile = keep.sum((1, 2)).double()
            n_sm = torch.cuda.get_device_properties(dev) \
                .multi_processor_count
            per_sm = torch.zeros(n_sm, dtype=torch.float64, device=dev)
            per_sm.index_add_(0, torch.arange(n_t, device=dev) % n_sm,
                              per_tile)
            res[f"b17_{what}_kept_per_tile_mean_max"] = [
                float(per_tile.mean()), float(per_tile.max())]
            res[f"b17_{what}_kept_per_sm_mean_max"] = [
                float(per_sm.mean()), float(per_sm.max())]
            res[f"b17_{what}_ms"] = _turns(
                {m: (lambda m=m, a=(a, o, t): _blend(libs[m], *a))
                 for m in names}, names + names[::-1])
        rng = np.random.default_rng(31)
        n_t, n_px = attrs.shape[0], tile * tile
        g = tuple(torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                  .to(dev) for sh in ((n_t, n_px, 3), (n_t, n_px),
                                      (n_t, n_px)))
        two = ("gs_parent", "gs_new")
        res["b18_bench_bitwise_vs_parent"] = bool(torch.equal(
            *(_blend_bwd(libs[m], attrs, origin, g, tile) for m in two)))
        res["b18_bench_ms"] = _turns(
            {m: (lambda m=m: _blend_bwd(libs[m], attrs, origin, g, tile))
             for m in two}, two + two[::-1])
    return res


def _check(res: dict) -> list:
    """What the run must show (every error within its tolerance, every
    yes-or-no check true); the names of what failed."""
    bad = []
    for part in ("brick", "gs"):
        for key, v in res[part].items():
            tol = res[part].get(key[:-4] + "_tol")
            if key.endswith("_err") and tol is not None and v > tol:
                bad.append(f"{part}.{key}")
            if isinstance(v, bool) and not v:
                bad.append(f"{part}.{key}")
    return bad


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not Path(sys.argv[1], "brick.cu").is_file():
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as CS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = CS._smi()
    print(f"[device] {smi}")
    t0 = time.perf_counter()
    paths = _build()
    print(f"[build] {len(paths)} libraries: {time.perf_counter() - t0:.1f} s")
    sass = {name: {k: v for k, v in CS._sass_functions(paths[name]).items()
                   if _ours(k)} for name in (
        "brick_parent", "brick_new", "gs_parent", "gs_new",
        "gs_scalar_loads")}
    res = {"device": smi,
           "sass": {name: {k: len(v) for k, v in code.items()}
                    for name, code in sass.items()},
           "b17_walk_instructions_per_pair": {
               name: CS._walk_per_pair(code[k])
               for name, code in sass.items()
               for k in code if "gs_blend" in k}}
    print(f"[sass] {json.dumps(res['sass'])}; B17's walk, instructions a "
          f"pair: {json.dumps(res['b17_walk_instructions_per_pair'])}")
    libs = {n: _load(p) for n, p in paths.items()}
    res["brick"] = _brick({n: l for n, l in libs.items()
                           if n.startswith("brick")}, dev)
    print(f"[B7] {json.dumps(res['brick'])}")
    res["gs"] = _gs({n: l for n, l in libs.items() if n.startswith("gs")},
                    dev)
    print(f"[B17] {json.dumps(res['gs'])}")
    res["failed"] = _check(res)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
