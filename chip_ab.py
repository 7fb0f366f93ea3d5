#!/usr/bin/env python3
"""Time the parent commit's B16 and B8 kernels against this tree's, in
turns, on one card, with probes, and compare their outputs: the F=4 cell
permuto nablas B16 (`permuto4_dydx`, `csrc/permuto_cell4.cu`) and the F=2
brick nablas B8 (`brick_dydx`, `csrc/brick.cu`).

    git archive <parent> nr3d_lib_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_ab.py _archive/parent/nr3d_lib_tpu_torch/csrc

(`_archive/` is listed in `.gitignore`; run the second line where the
card is.) Builds, with the port's nvcc flags, into `_archive/ab_build/`,
one nvcc per library, all started together, each source with its own
directory's headers (`-I`): the parent's and this tree's
`permuto_cell4.cu`, `brick.cu` and `permuto_cell.cu`, and probes made by
text substitution, in lieu of `ncu`:

- `p4_selects`: B16 with `elevation_vjp`'s 2(d+1)² compares and selects
  in place of `elevation_terms`' rank tables (wrong outputs: the selects'
  cost);
- `p4_noloads`: B16 without its table loads (each vertex's words made
  from its slot: wrong outputs, the loads' cost);
- `p4_search`: B16 without its table loads and without the vjp (the
  terms are products of the weights: what the search costs);
- `b8_stage_x`: B8 with x staged in shared memory behind a barrier, as
  B7 and B9 stage it, not read by each lane (right);
- `b8_noloads`: B8 without its table loads (each corner's value made
  from its slot: wrong outputs, the loads' cost);
- `b8_one_row`: B8 with every lane of a warp reading its corners from
  lane 0's brick row (wrong outputs: what the lanes' scattered rows cost
  the loads, at the same load instructions);
- `b8_parent_64`: the parent's B8, one thread a point, in blocks of 64
  threads, not 256 (right): what filling the card's wave gives without
  the level-major warps.

Prints each library's ptxas registers of B16 and B8, and their SASS
instruction counts, and checks that the kernels whose sources did not
change have the parent's instruction lists: B14, B15 and the search
checks (`permuto_cell4.cu`), B6 in both forms, B7 and B9 (`brick.cu`),
and every kernel of `permuto_cell.cu` (B10–B13, which share the search
header). Then, with the tolerances of `chip_smoke.py`:

- B16 at path C's seeded model and points from `chip_smoke.py`
  (393,216 (x,t) points × 4 levels, 14,080 rows), in ray order and
  randomly permuted: dx bitwise the parent's (and the right probes'),
  within 1e-4 of the plain version, a permuted batch's dx the permuted
  dx; times in turns (parent, new, probes, probes reversed, new,
  parent) and the bound; and bitwise the parent's at d = 3 (the GPU
  tests' `small3d` meta) in both orders, and at d = 2 and 5;
- B8 at the F=2 NeuS step's 147,456 points × 4 levels (9,648 rows),
  ray order and permuted, likewise with its probes; bitwise the parent's
  at both F=2 metas of the GPU tests in both orders; and on the inputs
  the F=2 render hands it, parent and new in turns;
- inside the paths, with the wrapper (`permuto_cell4._dydx_cuda`,
  `lotd_brick._dydx_cuda`) routed to the parent's or the new library in
  turns (torch.profiler, ms per pass over three passes): B16 in path C's
  render (1 launch) and train step (1), B8 in the F=2 NeuS render (1)
  and train step (1); the kernel's device time and the pass's in each,
  and the pass's outputs bitwise equal between the two libraries.

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

# ---------------------------------------------- B16 (permuto_cell4.cu)
P4 = "permuto_cell4.cu"
TERMS = ("    elevation_terms<D>(s, gf, meta, hs + threadIdx.x, blockDim.x, "
         "t);")
P4_LOAD = """      unpack4(__ldg(table + s.vtx[k]), f);
      gf[k] = __fmaf_rn("""
P4_NO_LOAD = P4_LOAD.replace("__ldg(table + s.vtx[k])",
                             "make_uint2((unsigned)s.vtx[k], 0x3f803f80u)")
# ------------------------------------------------------ B8 (brick.cu)
B8F = "brick.cu"
B8_X = """  const int l = threadIdx.x >> 5, i = threadIdx.x & 31;
  if (i < np) {
    const float* xi = x + (p0 + i) * 3;
    const float xp[3] = {xi[0], xi[1], xi[2]};"""
B8_STAGED_X = """  __shared__ float xs[BRICK_POINTS * 3];
  for (int k = threadIdx.x; k < np * 3; k += blockDim.x) xs[k] = x[p0 * 3 + k];
  __syncthreads();
  const int l = threadIdx.x >> 5, i = threadIdx.x & 31;
  if (i < np) {
    const float xp[3] = {xs[i * 3], xs[i * 3 + 1], xs[i * 3 + 2]};"""
B8_LOAD = "      const float2 v = __ldg(rowp + corner_off(k));"
B8_ROW = "    const float2* rowp = table + (long long)c.row * 64 + c.vert0;"
B8_PARENT_LAUNCH = "brick_dydx_kernel<<<n_blocks(n, 256), 256, 0,"
PROBES = {
    "p4_selects": (P4, [(TERMS, """#pragma unroll
    for (int a = 0; a < D; ++a) t[a] = 0.f;
    elevation_vjp<D>(s, gf, meta, meta.lv[l], t);""")]),
    "p4_noloads": (P4, [(P4_LOAD, P4_NO_LOAD)]),
    "p4_search": (P4, [(P4_LOAD, P4_NO_LOAD), (TERMS, """#pragma unroll
    for (int a = 0; a < D; ++a) t[a] = __fmul_rn(s.bary[a], gf[a]);""")]),
    "b8_stage_x": (B8F, [(B8_X, B8_STAGED_X)]),
    "b8_noloads": (B8F, [(B8_LOAD, "      const float2 v = make_float2("
                          "(float)(c.row + corner_off(k)), 1.f);")]),
    # the runs of the paths' shapes fill whole warps, so no lane that
    # the shuffle reads has left the warp
    "b8_one_row": (B8F, [(B8_ROW, B8_ROW.replace(
        "c.row", "__shfl_sync(0xffffffffu, c.row, 0)"))]),
    # the parent's source, not this tree's
    "b8_parent_64": (B8F, [(B8_PARENT_LAUNCH, B8_PARENT_LAUNCH.replace(
        "256), 256", "64), 64"))]),
}
FROM_PARENT = ("b8_parent_64",)
P4_NAMES = ("p4_parent", "p4_new",
            *(k for k in PROBES if k.startswith("p4_")))
B8_NAMES = ("b8_parent", "b8_new",
            *(k for k in PROBES if k.startswith("b8_")))
# the probes whose outputs are right
P4_EXACT = ("p4_new",)
B8_EXACT = ("b8_new", "b8_stage_x", "b8_parent_64")
B16 = "permuto4_dydx_kernel"
B8 = "brick_dydx_kernel"
UNCHANGED = {"p4": ("permuto4_fwd_kernel", "permuto4_bwd_kernel",
                    "pc_check_div_kernel", "pc_check_mod_kernel"),
             "b8": ("brick_fwd_kernel", "brick_bwd_kernel",
                    "brick_bwd2_kernel"),
             "pc": ("",)}          # every kernel of permuto_cell.cu


def _probe(name: str, base: Path, fname: str, subs) -> tuple:
    """A copy of the sources in `base` in BUILD/name with each (old, new)
    of `subs` replaced in `fname` (each old text must occur once); (the
    copy's source, its -I dir)."""
    out = BUILD / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(base, out)
    text = (out / fname).read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{fname}: the text {name} replaces is not in "
                               f"it once: {old!r}")
        text = text.replace(old, new)
    (out / fname).write_text(text)
    return out / fname, out


def _nvcc_all(sources: dict) -> None:
    """One nvcc per library, all started together; prints ptxas'
    registers of B16's and B8's instances."""
    from nr3d_lib_tpu_torch.ops import _build as Bu

    procs = {}
    for name, (src, inc) in sources.items():
        cmd = [Bu._nvcc(), *Bu.NVCC_FLAGS, "-I", str(inc), "-o",
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
            elif "registers" in line and (B16 in entry or B8 in entry):
                print(f"[ptxas {name}] {entry[:48]}: {line.strip()}")


def _build() -> dict:
    parent = Path(sys.argv[1]).resolve()
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = {}
    for tag, fname in (("p4", P4), ("b8", B8F), ("pc", "permuto_cell.cu")):
        sources[f"{tag}_parent"] = (parent / fname, parent)
        sources[f"{tag}_new"] = (NEW / fname, NEW)
    sources.update({name: _probe(name, parent if name in FROM_PARENT
                                 else NEW, fname, subs)
                    for name, (fname, subs) in PROBES.items()})
    _nvcc_all(sources)
    return {name: BUILD / f"lib{name}.so" for name in sources}


def _load(path: Path) -> ctypes.CDLL:
    from nr3d_lib_tpu_torch.ops import lotd_brick as B
    from nr3d_lib_tpu_torch.ops import permuto_cell as PCM

    vp, n = ctypes.c_void_p, ctypes.c_longlong
    lib = ctypes.CDLL(str(path))
    if path.name.startswith("libp4"):
        lib.permuto4_dydx.argtypes = [vp, vp, vp, PCM._Meta, vp, n, vp]
        lib.permuto4_dydx.restype = ctypes.c_int
    elif path.name.startswith("libb8"):
        lib.brick_dydx.argtypes = [vp, vp, vp, B._Meta, vp, n, vp]
        lib.brick_dydx.restype = ctypes.c_int
    return lib


def _dydx4(lib, g_up, x, packed, meta):
    """B16 of one library → dx [N, d]."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import permuto_cell as PCM

    dx = torch.empty_like(x)
    Bu.check(lib.permuto4_dydx(g_up.data_ptr(), x.data_ptr(),
                               packed.data_ptr(), PCM.c_meta(meta),
                               dx.data_ptr(), x.shape[0],
                               Bu.stream_ptr(x.device)), "permuto4_dydx")
    return dx


def _dydx2(lib, g_up, x, table, meta):
    """B8 of one library → dx [N, 3]."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    dx = torch.empty_like(x)
    Bu.check(lib.brick_dydx(g_up.data_ptr(), x.data_ptr(), table.data_ptr(),
                            B.c_meta(meta), dx.data_ptr(), x.shape[0],
                            Bu.stream_ptr(x.device)), "brick_dydx")
    return dx


def _turns(fns: dict, order) -> dict:
    import chip_smoke as CS

    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(CS._time_ms(fns[k]))
    return ms


def _same(res: dict, key: str, a, b) -> None:
    import torch

    res[key] = bool(torch.equal(a, b))


def _models():
    """`chip_smoke.py`'s path C model and F=2 NeuS, seeded as it seeds
    them."""
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel
    from nr3d_lib_tpu_torch.models.model_families import \
        DynamicPermutoNeuSModel

    dyn = DynamicPermutoNeuSModel(**CS.DYN_CFG, seed=0)
    CS._seed_weights(dyn, dyn.field.implicit_surface.bank, 4)
    dyn.populate()
    neus2 = LoTDNeuSModel(**CS.NEUS_F2_CFG, seed=0)
    CS._seed_weights(neus2, neus2.field.implicit_surface.encoding, 3)
    neus2.populate()
    CS._seed_occupancy(neus2)
    return dyn, neus2


def _rays(dev):
    import torch
    import chip_smoke as CS

    o, d = (torch.from_numpy(a).to(dev) for a in CS._rays(CS.N_RAYS, seed=0))
    ts = torch.from_numpy(np.random.default_rng(6).uniform(
        -1.0, 1.0, CS.N_RAYS).astype(np.float32)).to(dev)
    return o, d, ts


def _shape(libs: dict, call, names, exact, x, g, table, meta, plain,
           seed: int) -> dict:
    """One kernel (`call(lib, g, x, table, meta)`) on the points x, in ray
    order and permuted: bits against the parent and the plain version,
    and times in turns."""
    import torch

    dev, n = x.device, x.shape[0]
    tag = names[0].split("_")[0]
    perm = torch.randperm(n, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
    r = {"n": n, "levels": meta.n_levels, "rows": meta.total_rows}
    for order, xx, gg in (("ray", x, g),
                          ("permuted", x[perm].contiguous(),
                           g[perm].contiguous())):
        out = {m: call(libs[m], gg, xx, table, meta)
               for m in (f"{tag}_parent", *exact)}
        for m in exact:
            _same(r, f"{order}_{m}_bitwise_vs_parent", out[m],
                  out[f"{tag}_parent"])
        if order == "ray":
            ray_dx = out[f"{tag}_new"]
            r["dx_err"] = float((ray_dx - plain).abs().max())
            r["dx_tol"] = 1e-4 + 1e-4 * float(plain.abs().max())
        else:
            _same(r, "permuted_dx_is_the_permuted_dx", out[f"{tag}_new"],
                  ray_dx[perm])
        r[f"{order}_ms"] = _turns(
            {m: (lambda m=m, a=xx, b=gg: call(libs[m], b, a, table, meta))
             for m in names}, names + names[::-1])
    return r


def _bits(res: dict, key: str, libs: dict, call, tag: str, x, g, table,
          meta, seed: int) -> None:
    """New against parent, bit for bit, in ray order and permuted."""
    import torch

    perm = torch.randperm(x.shape[0], device=x.device,
                          generator=torch.Generator(x.device).manual_seed(
                              seed))
    for order, xx, gg in (("ray", x, g), ("permuted", x[perm].contiguous(),
                                          g[perm].contiguous())):
        _same(res, f"{key}_{order}_bitwise_vs_parent",
              call(libs[f"{tag}_new"], gg, xx, table, meta),
              call(libs[f"{tag}_parent"], gg, xx, table, meta))


def _ray_inputs(dev, d: int, n: int, seed: int):
    """Points in [0,1]^d along seeded rays, sorted along each ray (the
    GPU tests' `_pc_ray_points`)."""
    import torch

    r = np.random.default_rng(seed)
    n_rays = -(-n // 96)
    o = r.uniform(0.0, 1.0, (n_rays, 1, d))
    v = r.normal(size=(n_rays, 1, d))
    v[..., 3:] = 0.0
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    t = np.sort(r.uniform(0.0, 0.8, (n_rays, 96, 1)), 1)
    x = np.clip(o + v * t, 0.0, 1.0).reshape(-1, d)[:n]
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _b16(libs: dict, dev, dyn) -> dict:
    """B16 at path C's shape, and its bits at d = 2, 3 and 5."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import permuto_cell4 as P4M

    o, d, ts = _rays(dev)
    bank = dyn.field.implicit_surface.bank
    meta = bank.meta
    with torch.no_grad():
        table = bank.flattened_params.detach()
        packed = P4M.pack_table4(table)
        x = CS._dyn_points(o, d, ts, 96, seed=16)
        g = torch.randn(x.shape[0], 4 * meta.n_levels, device=dev,
                        generator=torch.Generator(dev).manual_seed(17))
        res = {"path_c": _shape(
            libs, _dydx4, P4_NAMES, P4_EXACT, x, g, packed, meta,
            P4M.permuto_cell4_nablas_xla(g, x, table, meta), 18)}
        r = res["path_c"]
        r["d"] = meta.n_dims
        r["bound_ms"], r["bound_by"] = CS._b16_bound(
            x.shape[0], meta.n_dims, meta.n_levels, packed.numel() * 4)
        print(f"[B16 path_c] {json.dumps(r)}")
        # the GPU tests' other metas: bits only
        for dim, lod, rows in ((3, [2.0, 8.0, 24.0], 64),
                               (2, [4.0, 12.0, 40.0], 4096),
                               (5, [2.0, 6.0, 18.0], 4096)):
            mt = P4M.make_permuto_cell4_meta(dim, lod, rows)
            rng = np.random.default_rng(dim + 30)
            xs = _ray_inputs(dev, dim, 96 * 1001, dim + 31)
            tb = torch.from_numpy(rng.uniform(
                -0.1, 0.1, (mt.total_rows, 256)).astype(np.float32)).to(dev)
            gs = torch.from_numpy(rng.normal(
                size=(xs.shape[0], 4 * len(lod))).astype(np.float32)).to(dev)
            _bits(res, f"d{dim}", libs, _dydx4, "p4", xs, gs,
                  P4M.pack_table4(tb), mt, dim + 32)
    return res


def _recorded_calls(model, o, d, module, attr: str) -> list:
    """The arguments of each call of `module.attr` in one render of
    `model` under no_grad: [args]."""
    import torch
    import chip_smoke as CS

    calls, orig = [], getattr(module, attr)

    def recording(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    setattr(module, attr, recording)
    try:
        with torch.no_grad():
            model.ray_query(CS._tested(model, o, d))
        torch.cuda.synchronize()
    finally:
        setattr(module, attr, orig)
    return calls


def _b8(libs: dict, dev, neus2) -> dict:
    """B8 at the F=2 step's shape, its bits at both F=2 test metas, and on
    the F=2 render's own inputs."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    o, d, _ = _rays(dev)
    enc = neus2.field.implicit_surface.encoding
    meta = enc.meta
    two = ("b8_parent", "b8_new")
    with torch.no_grad():
        table = enc._build_table().detach()
        x = CS._ray_points(o, d, 36, seed=14)
        gen = torch.Generator(device=dev).manual_seed(15)
        g = torch.randn(x.shape[0], 2 * meta.n_levels, device=dev,
                        generator=gen)
        res = {"f2_step": _shape(libs, _dydx2, B8_NAMES, B8_EXACT, x, g,
                                 table, meta,
                                 B.brick_nablas_xla(g, x, table, meta), 18)}
        r = res["f2_step"]
        r["bound_ms"], r["bound_by"] = CS._b8_bound(
            x.shape[0], meta.n_levels, table.numel() * 4)
        print(f"[B8 f2_step] {json.dumps(r)}")
        # the GPU tests' F=2 metas: bits only
        for key, lod, types, rows in (
                ("dense_hash", [16, 32, 64, 128],
                 ["Dense", "Dense", "Hash", "Hash"], 4096),
                ("eight_levels", [8, 12, 16, 24, 32, 48, 64, 96],
                 ["Dense"] * 3 + ["Hash"] * 5, 256)):
            mt = B.make_brick_meta(lod, types, rows)
            rng = np.random.default_rng(len(lod) + 40)
            xs = _ray_inputs(dev, 3, 96 * 1001, len(lod) + 41)
            tb = torch.from_numpy(rng.uniform(
                -0.1, 0.1, (mt.total_rows, 128)).astype(np.float32)).to(dev)
            gs = torch.from_numpy(rng.normal(
                size=(xs.shape[0], 2 * len(lod))).astype(np.float32)).to(dev)
            _bits(res, key, libs, _dydx2, "b8", xs, gs, tb, mt,
                  len(lod) + 42)
        launches = []
        for args in _recorded_calls(neus2, o, d, B, "_dydx_cuda"):
            ga, xa, ta, mt = args[:4]
            ga, xa, ta = B.aligned(ga), B.aligned(xa), B.aligned(ta)
            r = {"n": int(xa.shape[0])}
            _same(r, "dx_bitwise_vs_parent", _dydx2(libs["b8_new"], ga, xa,
                                                    ta, mt),
                  _dydx2(libs["b8_parent"], ga, xa, ta, mt))
            r["ms"] = _turns({m: (lambda m=m: _dydx2(libs[m], ga, xa, ta,
                                                     mt)) for m in two},
                             two + two[::-1])
            r["bound_ms"] = CS._b8_bound(r["n"], mt.n_levels,
                                         ta.numel() * 4)[0]
            launches.append(r)
            print(f"[B8 render launch {len(launches) - 1}] {json.dumps(r)}")
        res["render_launches"] = launches
    return res


def _in_path(libs: dict, tag: str, module, attr: str, call, kernel: str,
             run) -> dict:
    """The kernel's device time and the pass's inside `run()` (three passes
    under torch.profiler), with `module.attr` routed by `call(lib, ...)`
    to the parent's or the new library (`tag`_parent, `tag`_new) in
    turns; and whether the passes' outputs are the same bits under
    both."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    orig, out, outputs = getattr(module, attr), {}, {}
    names = (f"{tag}_parent", f"{tag}_new")

    def one(name):
        setattr(module, attr, lambda *a, **kw: call(libs[name], *a, **kw))
        try:
            run()                                   # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    got = run()
                torch.cuda.synchronize()
        finally:
            setattr(module, attr, orig)
        outputs.setdefault(name, got)
        t = {"kernel": 0.0, "kernel_events": 0, "pass": 0.0}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA or \
                    getattr(ev, "is_user_annotation", False):
                continue
            ms = getattr(ev, "self_device_time_total", 0.0) / 3e3
            t["pass"] += ms
            if kernel in ev.key:
                t["kernel"] += ms
                t["kernel_events"] += ev.count / 3
        if not t["kernel"]:
            raise RuntimeError(f"no {kernel} in the pass's profile")
        for k, v in t.items():
            out.setdefault(k, {}).setdefault(name, []).append(v)

    for name in names + names[::-1]:
        one(name)
    a, b = (outputs[n] for n in names)
    out["outputs_bitwise_equal"] = all(torch.equal(a[k], b[k]) for k in a)
    return out


def _paths(libs: dict, dev, dyn, neus2) -> dict:
    """B16 inside path C's render and train step; B8 inside the F=2 NeuS
    render and train step."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick as B
    from nr3d_lib_tpu_torch.ops import permuto_cell4 as P4M

    o, d, ts = _rays(dev)
    extra = {"ts": ts}

    def dydx4(lib, g_up, x, packed, meta):
        return _dydx4(lib, P4M.aligned(g_up), P4M.aligned(x), packed, meta)

    def dydx2(lib, g_up, x, table, meta):
        return _dydx2(lib, B.aligned(g_up), B.aligned(x), B.aligned(table),
                      meta)

    def render(model, ext=None):
        def go():
            with torch.no_grad():
                rendered, _ = model.ray_query(CS._tested(model, o, d, ext))
            return {k: v for k, v in rendered.items()
                    if isinstance(v, torch.Tensor)}
        return go

    def step(model, ext=None):
        def go():
            g = torch.Generator(device=dev).manual_seed(9)
            model.training_before_per_step(1, g)
            with torch.enable_grad():
                loss = CS._step_loss(model, o, d, ext, generator=g)
                loss.backward()
            model.zero_grad(set_to_none=True)
            return {"loss": loss.detach()}
        return go

    res = {}
    for key, tag, module, call, kernel, run in (
            ("b16_path_c_render", "p4", P4M, dydx4, B16, render(dyn, extra)),
            ("b16_path_c_step", "p4", P4M, dydx4, B16, step(dyn, extra)),
            ("b8_f2_render", "b8", B, dydx2, B8, render(neus2)),
            ("b8_f2_step", "b8", B, dydx2, B8, step(neus2))):
        res[key] = _in_path(libs, tag, module, "_dydx_cuda", call, kernel,
                            run)
        print(f"[in the path: {key}] {json.dumps(res[key])}")
    return res


def _check(res: dict) -> list:
    """What the run must show (every error within its tolerance, every
    yes-or-no check true); the names of what failed."""
    bad = []

    def walk(path, v):
        if isinstance(v, dict):
            for k, w in v.items():
                if k.endswith("_err") and v.get(k[:-4] + "_tol") is not None \
                        and w > v[k[:-4] + "_tol"]:
                    bad.append(f"{path}.{k}")
                walk(f"{path}.{k}", w)
        elif isinstance(v, list):
            for i, w in enumerate(v):
                walk(f"{path}[{i}]", w)
        elif isinstance(v, bool) and not v:
            bad.append(path)

    walk("res", {k: v for k, v in res.items() if k != "sass"})
    return bad


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not Path(sys.argv[1], P4).is_file():
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
    sass = {name: CS._sass_functions(p) for name, p in paths.items()}
    res = {"device": smi,
           "sass": {name: {k: len(v) for k, v in code.items()
                           if B16 in k or B8 in k}
                    for name, code in sass.items()}}

    def instrs(name, kernel):
        return [i for k, v in sass[name].items() if kernel in k for _, i in v]

    for tag, kernels in UNCHANGED.items():
        res[f"{tag}_unchanged_sass_same_as_parent"] = all(
            instrs(f"{tag}_new", k) == instrs(f"{tag}_parent", k) and
            instrs(f"{tag}_new", k) for k in kernels)
    same = [res[f"{t}_unchanged_sass_same_as_parent"] for t in UNCHANGED]
    print(f"[sass] {json.dumps(res['sass'])}; unchanged kernels the "
          f"parent's: {same}")
    libs = {n: _load(p) for n, p in paths.items() if not n.startswith("pc")}
    dyn, neus2 = _models()
    res["b16"] = _b16(libs, dev, dyn)
    res["b8"] = _b8(libs, dev, neus2)
    res["paths"] = _paths(libs, dev, dyn, neus2)
    res["failed"] = _check(res)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
