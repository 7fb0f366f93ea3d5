#!/usr/bin/env python3
"""Time the parent commit's B2 and B4 kernels against this tree's, in
turns, on one card, with probes, and compare their outputs: the F=4
brick encode's backward B2 (`brick4_bwd`, `csrc/brick4.cu`) and the
nablas' backward B4 (`brick4_bwd2`); and B15 (`permuto4_bwd`,
`csrc/permuto_cell4.cu`), whose `warp_add4` moved into
`csrc/warp_atomics.cuh` for B2 and B4 to share.

    git archive <parent> nr3d_lib_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_ab.py _archive/parent/nr3d_lib_tpu_torch/csrc

(`_archive/` is listed in `.gitignore`; run the second line where the
card is.) Builds, with the port's nvcc flags, into `_archive/ab_build/`,
one nvcc per library, all started together, each source with its own
directory's headers (`-I`): the parent's and this tree's `brick4.cu` and
`permuto_cell4.cu`, and probes made by text substitution, in lieu of
`ncu`:

- `brick4_noatomics`: this tree's `warp_add4` (`warp_atomics.cuh`) sends
  each sum to a register sink that is never stored (wrong table
  gradients: the atomics' and the aggregation's cost);
- `brick4_lane_atomics`: `warp_add4` issues one atomic per lane (the
  aggregation off: the parent's atomics in this tree's warps);
- `brick4_runs2`: a block takes two runs of 32 points (`BRICK4_RUNS` 2,
  blockDim 64 L);
- `brick4_parent_noatomics`: the parent's B2 and B4 without their
  atomics (its `atomic_add4` returns at once).

Prints each library's ptxas registers and the SASS instruction counts of
B2, B4 and B15 (B15's instructions, parent and new, must be the same
list), then, with the tolerances of `chip_smoke.py`:

- B2 and B4 at the F=4 NeuS train step's shape (`chip_smoke.py`'s
  147,456 points along rays × 2 levels, 4221 rows), ray order and
  randomly permuted: the gradients against the plain version; B4's
  dL/dg_up and dL/dx bitwise equal to the parent's (with and without
  dL/dx); B2's dL/dx bitwise equal in two runs and between the orders;
  dL/dtable's largest and root-mean-square distance to a float64 sum of
  the same contributions (the plain version's and six runs each of the
  parent's, the new and the one-atomic-a-lane kernels'; the new no
  farther than the parent's, on the mean of the runs); the float4
  atomics issued
  (`ops/lotd_brick.brick_atomic_groups`); times in turns (parent, new,
  probes, probes reversed, new, parent) without dL/dx (the step's form)
  and, parent and new, with it;
- B2 and B4 on the step's own inputs: the arguments that their wrappers
  receive inside the F=4 NeuS train step, recorded
  (`chip_smoke._record_step`) at two steps of one run of `chip_smoke.py`'s
  train step from its seeded weights: it = 4 (after three steps) and the
  step that `chip_smoke.py` itself records, it = 23 (after its 2 warm-up
  and 20 timed steps, across the occupancy update at it = 16). At each:
  the points as recorded and permuted, the atomics they need, times
  alone in turns, with a cold L2 as well, and B2's and B4's device time
  inside that step with the step's device time (torch.profiler over
  three of its forward-backward passes, both wrappers routed to the
  parent's or the new library, in turns);
- B15 at path C's shape (`chip_smoke.py`'s 393,216 (x,t) points × 4
  levels, 14,080 rows): dL/dx bitwise equal to the parent's, dL/dtable
  against the plain version, times in turns with and without dL/dx, ray
  order and permuted.

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

# the body of warp_add4, from its first line to its last
AGG_FIRST = "  const unsigned peers = __match_any_sync(active, key);"
AGG_LAST = "  if (below == 0u) atomic_add4(dst + key, v);"
NO_ATOMICS = ("  if (v.x == 1.0e38f && v.y == -1.0e38f) "
              "atomic_add4(dst + key, v);")
LANE_ATOMICS = "  atomic_add4(dst + key, v);"
RUNS_1 = "constexpr int BRICK4_RUNS = 1;"
RUNS_2 = "constexpr int BRICK4_RUNS = 2;"
# the parent's float4 atomic, shared by its B2 and B4
PARENT_ATOMIC = \
    "__device__ __forceinline__ void atomic_add4(float4* dst, float4 v) {"
PARENT_SINK = (PARENT_ATOMIC +
               "\n  if (v.x != 1.0e38f || v.y != -1.0e38f) return;")
PROD_META = ([16, 64], ["Dense", "Hash"], 4096)
KERNELS = ("brick4_bwd_kernel", "brick4_bwd2_kernel", "permuto4_bwd_kernel")


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
    a = text.index(AGG_FIRST, text.index("void warp_add4("))
    return text[a:text.index(AGG_LAST, a) + len(AGG_LAST)]


def _ours(kernel: str) -> bool:
    return any(k in kernel for k in KERNELS)


def _nvcc_all(sources: dict) -> None:
    """One nvcc per library, all started together; prints ptxas'
    registers of B2's, B4's and B15's kernels."""
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


def _build() -> dict:
    parent = Path(sys.argv[1]).resolve()
    BUILD.mkdir(parents=True, exist_ok=True)
    body = _agg_body()
    sources = {
        "brick4_parent": (parent / "brick4.cu", parent),
        "brick4_new": (NEW / "brick4.cu", NEW),
        "brick4_noatomics": _probe("brick4_noatomics", NEW,
                                   "warp_atomics.cuh", body, NO_ATOMICS,
                                   "brick4.cu"),
        "brick4_lane_atomics": _probe("brick4_lane_atomics", NEW,
                                      "warp_atomics.cuh", body,
                                      LANE_ATOMICS, "brick4.cu"),
        "brick4_runs2": _probe("brick4_runs2", NEW, "brick4.cu", RUNS_1,
                               RUNS_2, "brick4.cu"),
        "brick4_parent_noatomics": _probe(
            "brick4_parent_noatomics", parent, "brick4.cu", PARENT_ATOMIC,
            PARENT_SINK, "brick4.cu"),
        "p4_parent": (parent / "permuto_cell4.cu", parent),
        "p4_new": (NEW / "permuto_cell4.cu", NEW),
    }
    _nvcc_all(sources)
    return {name: BUILD / f"lib{name}.so" for name in sources}


def _load(path: Path) -> ctypes.CDLL:
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    vp, n = ctypes.c_void_p, ctypes.c_longlong
    lib = ctypes.CDLL(str(path))
    if hasattr(lib, "brick4_bwd"):
        sigs = {"brick4_bwd": [vp, vp, vp, vp, B4._Meta, vp, vp, n, vp],
                "brick4_bwd2": [vp, vp, vp, vp, B4._Meta, vp, vp, vp, n,
                                vp]}
    else:
        sigs = {"permuto4_bwd": [vp, vp, vp, PC._Meta, vp, vp, n, vp]}
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


def _bwd(lib, x, g, meta, need_dx=False, words=None):
    """B2 of one library → (dL/dx or None, dL/dtable [rows, 256])."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    dtab = torch.empty(meta.total_rows, 256, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    Bu.check(lib.brick4_bwd(x.data_ptr(), g.data_ptr(),
                            words.data_ptr() if need_dx else None, None,
                            B4.c_meta(meta, B4._Meta), dtab.data_ptr(),
                            dx.data_ptr() if need_dx else None, x.shape[0],
                            Bu.stream_ptr(x.device)), "brick4_bwd")
    return dx, dtab


def _bwd2(lib, g_up, x, packed, gg, meta, need_dx=False):
    """B4 of one library → (dL/dg_up, dL/dx or None, dL/dtable)."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    dgup = torch.empty_like(g_up)
    dtab = torch.empty(meta.total_rows, 256, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    Bu.check(lib.brick4_bwd2(g_up.data_ptr(), x.data_ptr(), packed.data_ptr(),
                             gg.data_ptr(), B4.c_meta(meta, B4._Meta),
                             dgup.data_ptr(), dtab.data_ptr(),
                             dx.data_ptr() if need_dx else None, x.shape[0],
                             Bu.stream_ptr(x.device)), "brick4_bwd2")
    return dgup, dx, dtab


def _p4_bwd(lib, x, g, meta, packed=None):
    """B15 of one library → (dL/dx or None, dL/dtable [rows, 256])."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    dtab = torch.empty(meta.total_rows, 256, device=x.device)
    dx = torch.empty_like(x) if packed is not None else None
    Bu.check(lib.permuto4_bwd(x.data_ptr(), g.data_ptr(),
                              None if packed is None else packed.data_ptr(),
                              PC.c_meta(meta), dtab.data_ptr(),
                              None if dx is None else dx.data_ptr(),
                              x.shape[0], Bu.stream_ptr(x.device)),
             "permuto4_bwd")
    return dx, dtab


def _rays(dev):
    import torch
    import chip_smoke as CS

    return (torch.from_numpy(a).to(dev) for a in CS._rays(CS.N_RAYS, seed=0))


def _f64_dtab(x, meta, g, gg=None):
    """dL/dtable [rows·64, 4] in float64 from the kernels' float32 cell
    fractions: B2's Σ w_k g or, with gg, B4's Σ c_k g_up, c_k = Σ_a
    gg_a (res_a − 2) dw_k/dfrac_a."""
    import torch
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    dev = x.device
    ref = torch.zeros(meta.total_rows * 64, 4, dtype=torch.float64,
                      device=dev)
    bits = B._corner_bits(dev)
    offs = (bits[:, 0] * 4 + bits[:, 1]) * 4 + bits[:, 2]
    bd = bits.double()
    for l, lv in enumerate(meta.levels):
        row, lane0, frac = B._level_rows_and_lanes(x, lv)
        f = frac.double()[:, None, :]
        sel = f * bd + (1.0 - f) * (1.0 - bd)                      # [N,8,3]
        if gg is None:
            c = sel.prod(-1)
        else:
            scale = torch.tensor([r - 2.0 for r in lv.res],
                                 dtype=torch.float64, device=dev)
            dd = gg.double() * scale                               # [N,3]
            c = sum(dd[:, None, a] * (2.0 * bd[:, a] - 1.0) *
                    sel[..., (a + 1) % 3] * sel[..., (a + 2) % 3]
                    for a in range(3))
        slot = row[:, None] * 64 + lane0[:, None] // 2 + offs
        ref.index_add_(0, slot.reshape(-1), (
            c[..., None] * g[:, None, 4 * l:4 * l + 4].double())
            .reshape(-1, 4))
    return ref


def _f64_dist(dtabs, ref) -> dict:
    """Each dL/dtable's largest and root-mean-square distance to `ref`."""
    err = [(t.double().view(ref.shape) - ref).abs() for t in dtabs]
    return {"max": [float(e.max()) for e in err],
            "rms": [float(e.square().mean().sqrt()) for e in err]}


def _no_farther(dist: dict, new: str, parent: str) -> bool:
    """The new kernel's dL/dtable no farther from the float64 sum than the
    parent's, by the mean over the runs of both distances (the largest
    distance of one run moves with the atomics' order)."""
    return all(np.mean(dist[new][k]) <= np.mean(dist[parent][k])
               for k in ("max", "rms"))


def _steps(dev, its: tuple):
    """`chip_smoke.py`'s F=4 NeuS (`PROD_CFG`) from its seeded weights
    and occupancy, trained by its train step (`chip_smoke._train_step`);
    yields (it, model, rays) just before each train step `it` in `its`."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    o, d = _rays(dev)
    m = LoTDNeuSModel(**CS.PROD_CFG, seed=0)
    CS._seed_weights(m, m.field.implicit_surface.encoding, 1)
    m.populate()
    CS._seed_occupancy(m)
    opt, gen = CS._train_state(m, dev)
    for it in range(1, max(its) + 1):
        if it in its:
            yield it, m, (o, d)
        with torch.enable_grad():
            CS._train_step(m, opt, gen, o, d, it)


def _in_step_ms(libs: dict, dev, model, rays, it: int, names) -> dict:
    """B2's and B4's device time inside train step `it` (its forward and
    backward, no optimizer step, the generator seeded as
    `chip_smoke._record_step` seeds it), and the pass's device time, with
    both wrappers routed to each library in `names`, in turns: ms per
    pass over three passes (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    orig, out = (B4._bwd_cuda, B4._bwd2_cuda), {}

    def one(name):
        def via_bwd(x, g, meta, *, need_dx, words=None, packed=None):
            if need_dx:
                raise RuntimeError("the step's B2 runs without dL/dx")
            return _bwd(libs[name], B4.aligned(x), B4.aligned(g), meta)

        def via_bwd2(g_up, x, packed, gg, meta, need_dx=True):
            dg, dx, dtab = _bwd2(libs[name], *(B4.aligned(t) for t in (
                g_up, x, packed, gg)), meta, need_dx)
            return dg, dx, dtab

        B4._bwd_cuda, B4._bwd2_cuda = via_bwd, via_bwd2
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
            B4._bwd_cuda, B4._bwd2_cuda = orig
        got = {"b2": 0.0, "b4": 0.0, "pass": 0.0}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA or \
                    getattr(ev, "is_user_annotation", False):
                continue
            ms = getattr(ev, "self_device_time_total", 0.0) / 3e3
            got["pass"] += ms
            if "brick4_bwd_kernel" in ev.key:
                got["b2"] += ms
            elif "brick4_bwd2_kernel" in ev.key:
                got["b4"] += ms
        if not (got["b2"] and got["b4"]):
            raise RuntimeError("no brick4_bwd(2)_kernel in the step's "
                               "profile")
        for k, v in got.items():
            out.setdefault(k, {}).setdefault(name, []).append(v)

    for name in tuple(names) + tuple(names)[::-1]:
        one(name)
    return out


def _brick4(libs: dict, dev) -> dict:
    """B2 and B4 at the F=4 NeuS train step's shape, and on the step's own
    inputs."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick as B
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    o, d = _rays(dev)
    meta = B4.make_brick4_meta(*PROD_META)
    x = CS._ray_points(o, d, 36, seed=3)
    n, L = x.shape[0], meta.n_levels
    table = torch.from_numpy(np.random.default_rng(15).uniform(
        -0.1, 0.1, (meta.total_rows, 256)).astype(np.float32)).to(dev)
    packed = B4.pack_table4(table)
    gen = torch.Generator(dev).manual_seed(16)
    g = torch.randn(n, 4 * L, device=dev, generator=gen)
    gg = torch.randn(n, 3, device=dev, generator=gen)
    perm = torch.randperm(n, device=dev,
                          generator=torch.Generator(dev).manual_seed(5))
    res = {"n": n, "rows": meta.total_rows, "atomics_naive": n * L * 8}
    names = ("brick4_parent", "brick4_new", "brick4_noatomics",
             "brick4_lane_atomics", "brick4_runs2",
             "brick4_parent_noatomics")
    two = ("brick4_parent", "brick4_new")

    with torch.no_grad():
        ref2, ref4 = _f64_dtab(x, meta, g), _f64_dtab(x, meta, g, gg)
        res["b2_dtab_vs_f64"] = {"plain": _f64_dist(
            [B4.brick4_encode_bwd_xla(x, table, g, meta, False)[1]], ref2)}
        res["b4_dtab_vs_f64"] = {"plain": _f64_dist(
            [B4.brick4_nablas_bwd_xla(g, x, table, gg, meta)[2]], ref4)}
        for m in ("brick4_parent", "brick4_new", "brick4_lane_atomics"):
            res["b2_dtab_vs_f64"][m] = _f64_dist(
                [_bwd(libs[m], x, g, meta)[1] for _ in range(6)], ref2)
            res["b4_dtab_vs_f64"][m] = _f64_dist(
                [_bwd2(libs[m], g, x, packed, gg, meta)[2]
                 for _ in range(6)], ref4)
        for k in ("b2", "b4"):
            res[f"{k}_dtab_no_farther_than_parent"] = _no_farther(
                res[f"{k}_dtab_vs_f64"], "brick4_new", "brick4_parent")
        del ref2, ref4
        dxs = {}
        for order, xx, g2, gg2 in (
                ("ray", x, g, gg),
                ("permuted", *(v[perm].contiguous() for v in (x, g, gg)))):
            groups = B.brick_atomic_groups(xx, meta)
            res[f"{order}_atomic_groups"] = sum(groups)
            res[f"{order}_atomic_groups_by_level"] = groups
            words = B4._fwd_cuda(xx, packed, meta, want_g=True)[1]
            # B2
            dx_p, dt_p = B4.brick4_encode_bwd_xla(xx, table, g2, meta, True)
            dx, dtab = _bwd(libs["brick4_new"], xx, g2, meta, True, words)
            dx_par, _ = _bwd(libs["brick4_parent"], xx, g2, meta, True, words)
            dxs[order] = dx
            key = f"b2_{order}"
            res[f"{key}_dtab_err"] = float((dtab - dt_p).abs().max())
            res[f"{key}_dtab_tol"] = 1e-6 + 1e-5 * float(dt_p.abs().max())
            for m in ("brick4_lane_atomics", "brick4_runs2"):
                res[f"{key}_{m}_dtab_err"] = float(
                    (_bwd(libs[m], xx, g2, meta)[1] - dt_p).abs().max())
                res[f"{key}_{m}_dtab_tol"] = res[f"{key}_dtab_tol"]
            res[f"{key}_dx_err"] = float((dx - dx_p).abs().max())
            res[f"{key}_dx_tol"] = 1e-4 + 1e-4 * float(dx_p.abs().max())
            res[f"{key}_parent_dx_err"] = float((dx_par - dx_p).abs().max())
            res[f"{key}_dx_max_diff_vs_parent"] = float(
                (dx - dx_par).abs().max())
            res[f"{key}_dx_bitwise_between_runs"] = bool(torch.equal(
                dx, _bwd(libs["brick4_new"], xx, g2, meta, True, words)[0]))
            res[f"{key}_runs2_dx_bitwise"] = bool(torch.equal(
                dx, _bwd(libs["brick4_runs2"], xx, g2, meta, True, words)[0]))
            res[f"{key}_ms"] = _turns(
                {m: (lambda m=m, a=(xx, g2): _bwd(libs[m], *a, meta))
                 for m in names}, names + names[::-1])
            res[f"{key}_need_dx_ms"] = _turns(
                {m: (lambda m=m, a=(xx, g2): _bwd(libs[m], *a, meta, True,
                                                  words))
                 for m in two}, two + two[::-1])
            # B4
            dg_p, dx4_p, dt4_p = B4.brick4_nablas_bwd_xla(g2, xx, table, gg2,
                                                          meta)
            outs = {m: _bwd2(libs[m], g2, xx, packed, gg2, meta, True)
                    for m in ("brick4_parent", "brick4_new", "brick4_runs2")}
            dg, dx4, dt4 = outs["brick4_new"]
            key = f"b4_{order}"
            res[f"{key}_dgup_err"] = float((dg - dg_p).abs().max())
            res[f"{key}_dgup_tol"] = 1e-4 + 1e-4 * float(dg_p.abs().max())
            res[f"{key}_dx_err"] = float((dx4 - dx4_p).abs().max())
            res[f"{key}_dx_tol"] = 1e-4 + 1e-4 * float(dx4_p.abs().max())
            res[f"{key}_dtab_err"] = float((dt4 - dt4_p).abs().max())
            res[f"{key}_dtab_tol"] = 1e-6 + 1e-5 * float(dt4_p.abs().max())
            for m in ("brick4_new", "brick4_runs2"):
                sfx = "" if m == "brick4_new" else "_runs2"
                par = outs["brick4_parent"]
                res[f"{key}{sfx}_dgup_bitwise_vs_parent"] = bool(
                    torch.equal(outs[m][0], par[0]))
                res[f"{key}{sfx}_dx_bitwise_vs_parent"] = bool(
                    torch.equal(outs[m][1], par[1]))
            no_dx = {m: _bwd2(libs[m], g2, xx, packed, gg2, meta)
                     for m in two}
            res[f"{key}_no_dx_dgup_bitwise_vs_parent"] = bool(torch.equal(
                no_dx["brick4_new"][0], no_dx["brick4_parent"][0]))
            res[f"{key}_ms"] = _turns(
                {m: (lambda m=m, a=(g2, xx, packed, gg2): _bwd2(
                    libs[m], *a, meta)) for m in names}, names + names[::-1])
            res[f"{key}_need_dx_ms"] = _turns(
                {m: (lambda m=m, a=(g2, xx, packed, gg2): _bwd2(
                    libs[m], *a, meta, True)) for m in two}, two + two[::-1])
        res["b2_dx_bitwise_between_orders"] = bool(torch.equal(
            dxs["permuted"][torch.argsort(perm)], dxs["ray"]))

        # the step's own inputs at it = 4 and at the smoke's step, each as
        # recorded and permuted; B2 and B4 inside each step
        smoke_it = CS.N_WARMUP_STEPS + CS.N_STEPS + 1
        for it, model, rays in _steps(dev, (4, smoke_it)):
            key = f"step_it{it}"
            with torch.enable_grad():
                rec = CS._record_step(model, *rays, it, B4,
                                      ("_bwd_cuda", "_bwd2_cuda"))
                res[f"{key}_in_step_ms"] = _in_step_ms(libs, dev, model,
                                                       rays, it, two)
            _step_points(libs, dev, rec, key, names, two, res)
    return res


def _step_points(libs, dev, rec, key, names, two, res) -> None:
    """B2 and B4 alone on one step's recorded inputs (as recorded and
    permuted): atomics, times in turns, times with a cold L2, dL/dtable
    against the plain version (B2) and a float64 sum (B4), B4's dL/dg_up
    bitwise against the parent's; into `res` under `key`."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick as B
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    a2, a4 = rec["_bwd_cuda"], rec["_bwd2_cuda"]
    meta = a2["meta"]
    xs, gs = a2["x"], a2["g"]
    g_up, x4, packed, gg = a4["g_up"], a4["x"], a4["packed"], a4["gg"]
    ns = xs.shape[0]
    res[f"{key}_n"] = {"b2": ns, "b4": x4.shape[0]}
    res[f"{key}_need_dx"] = {"b2": a2["need_dx"], "b4": a4["need_dx"]}
    res[f"{key}_b4_same_points_as_b2"] = bool(torch.equal(x4, xs))
    res[f"{key}_atomics_naive"] = ns * meta.n_levels * 8
    ps = torch.randperm(ns, device=dev,
                        generator=torch.Generator(dev).manual_seed(6))
    for order, sel in (("ray", slice(None)), ("permuted", ps)):
        xx, g2 = xs[sel].contiguous(), gs[sel].contiguous()
        gu, x44, gg2 = (v[sel].contiguous() for v in (g_up, x4, gg))
        groups = B.brick_atomic_groups(xx, meta)
        res[f"{key}_{order}_atomic_groups"] = sum(groups)
        res[f"{key}_{order}_atomic_groups_by_level"] = groups
        res[f"{key}_{order}_b2_ms"] = _turns(
            {m: (lambda m=m: _bwd(libs[m], xx, g2, meta)) for m in names},
            names + names[::-1])
        res[f"{key}_{order}_b4_ms"] = _turns(
            {m: (lambda m=m: _bwd2(libs[m], gu, x44, packed, gg2, meta,
                                   a4["need_dx"])) for m in names},
            names + names[::-1])
    # the same, each launch after 128 MB written (the 50 MB L2 holds none
    # of their inputs or of the gradient table then), less the writes'
    # own time
    junk = torch.empty(32 * 2 ** 20, device=dev)
    flush = CS._time_ms(lambda: junk.fill_(1.0))
    res[f"{key}_flush_ms"] = flush
    for kern, fn in (("b2", lambda m: _bwd(libs[m], xs, gs, meta)),
                     ("b4", lambda m: _bwd2(libs[m], g_up, x4, packed, gg,
                                            meta, a4["need_dx"]))):
        res[f"{key}_ray_{kern}_cold_l2_ms"] = {
            m: [v - flush for v in vs] for m, vs in _turns(
                {m: (lambda m=m: (junk.fill_(1.0), fn(m))) for m in two},
                two + two[::-1]).items()}
    del junk
    zeros = torch.zeros(meta.total_rows, 256, device=dev)
    _, dt_p = B4.brick4_encode_bwd_xla(xs, zeros, gs, meta, False)
    dtab = _bwd(libs["brick4_new"], xs, gs, meta)[1]
    res[f"b2_{key}_dtab_err"] = float((dtab - dt_p).abs().max())
    res[f"b2_{key}_dtab_tol"] = 1e-6 + 1e-5 * float(dt_p.abs().max())
    outs = {m: _bwd2(libs[m], g_up, x4, packed, gg, meta, a4["need_dx"])
            for m in two}
    res[f"b4_{key}_dgup_bitwise_vs_parent"] = bool(torch.equal(
        outs["brick4_new"][0], outs["brick4_parent"][0]))
    dt4_p = _f64_dtab(x4, meta, g_up, gg)
    res[f"b4_{key}_dtab_err"] = float(
        (outs["brick4_new"][2].double().view(dt4_p.shape) - dt4_p)
        .abs().max())
    res[f"b4_{key}_dtab_tol"] = 1e-6 + 1e-5 * float(dt4_p.abs().max())


def _b15(libs: dict, dev) -> dict:
    """B15 at path C's shape, parent and new (only `warp_add4`'s place
    changed): dL/dx bitwise, dL/dtable against the plain version, times
    in turns."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.models.model_families import \
        DynamicPermutoNeuSModel
    from nr3d_lib_tpu_torch.ops import permuto_cell4 as P4

    o, d = _rays(dev)
    bank = DynamicPermutoNeuSModel(**CS.DYN_CFG, seed=0) \
        .field.implicit_surface.bank
    meta = bank.meta
    ts = torch.from_numpy(np.random.default_rng(6).uniform(
        -1.0, 1.0, CS.N_RAYS).astype(np.float32)).to(dev)
    x = CS._dyn_points(o, d, ts, 96, seed=16)
    n, L = x.shape[0], meta.n_levels
    table = torch.from_numpy(np.random.default_rng(17).uniform(
        -0.1, 0.1, (meta.total_rows, 256)).astype(np.float32)).to(dev)
    packed = P4.pack_table4(table)
    g = torch.randn(n, 4 * L, device=dev,
                    generator=torch.Generator(dev).manual_seed(18))
    perm = torch.randperm(n, device=dev,
                          generator=torch.Generator(dev).manual_seed(19))
    two = ("p4_parent", "p4_new")
    res = {"n": n, "rows": meta.total_rows}
    with torch.no_grad():
        dx_p, dt_p = P4.permuto_cell4_encode_bwd_xla(x, table, g, meta, True)
        outs = {m: _p4_bwd(libs[m], x, g, meta, packed) for m in two}
        res["b15_dx_bitwise_vs_parent"] = bool(torch.equal(
            outs["p4_new"][0], outs["p4_parent"][0]))
        res["b15_dtab_err"] = float((outs["p4_new"][1] - dt_p).abs().max())
        res["b15_dtab_tol"] = 1e-6 + 1e-5 * float(dt_p.abs().max())
        res["b15_dx_err"] = float((outs["p4_new"][0] - dx_p).abs().max())
        res["b15_dx_tol"] = 1e-4 + 1e-4 * float(dx_p.abs().max())
        for order, xx, g2 in (("ray", x, g), ("permuted", x[perm].contiguous(),
                                              g[perm].contiguous())):
            res[f"b15_{order}_ms"] = _turns(
                {m: (lambda m=m: _p4_bwd(libs[m], xx, g2, meta))
                 for m in two}, two + two[::-1])
        res["b15_need_dx_ms"] = _turns(
            {m: (lambda m=m: _p4_bwd(libs[m], x, g, meta, packed))
             for m in two}, two + two[::-1])
    return res


def _check(res: dict) -> list:
    """What the run must show (every error within its tolerance, every
    yes-or-no check true); the names of what failed."""
    bad = []
    for part in ("brick4", "b15"):
        for key, v in res[part].items():
            tol = res[part].get(key[:-4] + "_tol")
            if key.endswith("_err") and tol is not None and v > tol:
                bad.append(f"{part}.{key}")
            if isinstance(v, bool) and not v:
                bad.append(f"{part}.{key}")
    if not res["b15_sass_same_as_parent"]:
        bad.append("b15_sass_same_as_parent")
    return bad


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not Path(sys.argv[1], "brick4.cu").is_file():
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
        "brick4_parent", "brick4_new", "brick4_runs2", "p4_parent",
        "p4_new")}
    res = {"device": smi,
           "sass": {name: {k: len(v) for k, v in code.items()}
                    for name, code in sass.items()},
           "b15_sass_same_as_parent": all(
               [i for _, i in sass["p4_new"][k]] ==
               [i for _, i in sass["p4_parent"].get(k, [])]
               for k in sass["p4_new"])}
    print(f"[sass] {json.dumps(res['sass'])}; B15's the parent's: "
          f"{res['b15_sass_same_as_parent']}")
    libs = {n: _load(p) for n, p in paths.items()}
    res["b15"] = _b15({n: l for n, l in libs.items() if n.startswith("p4")},
                      dev)
    print(f"[B15] {json.dumps(res['b15'])}")
    res["brick4"] = _brick4({n: l for n, l in libs.items()
                             if n.startswith("brick4")}, dev)
    print(f"[B2 B4] {json.dumps(res['brick4'])}")
    res["failed"] = _check(res)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
