#!/usr/bin/env python3
"""Time the parent commit's B13 and B1 kernels against this tree's, in
turns, on one card, with probes, and compare their outputs: the F=2 cell
permuto nablas B13 (`permuto_dydx`, `csrc/permuto_cell.cu`, with
`elevation_terms` in `csrc/permuto_simplex.cuh`) and the F=4 brick encode
B1 (`brick4_fwd`, `csrc/brick4.cu`) in its want_g form (y and the corner
words that B2 reads back) and its y-only form.

    git archive <parent> nr3d_lib_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_ab.py _archive/parent/nr3d_lib_tpu_torch/csrc

(`_archive/` is listed in `.gitignore`; run the second line where the
card is.) Builds, with the port's nvcc flags, into `_archive/ab_build/`,
one nvcc per library, all started together, each source with its own
directory's headers (`-I`): the parent's and this tree's `permuto_cell.cu`,
`permuto_cell4.cu` and `brick4.cu`, and probes made by text substitution
of this tree's, in lieu of `ncu`:

- `pc_stage_x`, `pc_stage_g`, `pc_stage_xg`: B13 with x, g_up or both
  staged in shared memory behind a barrier before the search, as B10 and
  B12 stage them, not read by each lane (right);
- `pc_selects`: B13 with `elevation_vjp`'s 2(d+1)² compares and selects
  in place of `elevation_terms`' rank tables (wrong outputs: the selects'
  cost);
- `pc_noloads`: B13 without its table loads (each vertex value made from
  its slot: wrong outputs, the loads' cost);
- `pc_search`: B13 without its table loads and without the vjp (the
  terms are products of the weights: what the search costs);
- `b4_level_major`: B1 want_g in level-major warps (warp l the run at
  level l, y out through shared memory as B6), not point-major (right);
- `b4_lane_words`: B1 want_g's words stored by each lane as its own eight
  8-byte stores, not staged in shared memory (the parent's store pattern
  in this tree's blocks; right);
- `b4_nowords`: B1 want_g without storing its words (each store behind a
  test that fails: the words' cost).

Prints each library's ptxas registers of B13 and B1, and the SASS
instruction counts of B13 and B1, and checks that the kernels whose
sources did not change have the parent's instruction lists: B10 and
B11/B12 (`permuto_cell.cu`), B1's y-only kernel, B2, B3 and B4
(`brick4.cu`) and every kernel of `permuto_cell4.cu` (B14–B16 and the
search checks), which includes the edited header. Then, with the
tolerances of `chip_smoke.py`:

- B13 at its two `PERF.md` shapes, from `chip_smoke.py`'s seeded models
  and points: path D's final query (393,216 (x,t) points × 5 hashed
  levels, 20,480 rows) and the 3D lattice of the field phase (393,216
  points × 8 levels, one dense, 30,657 rows); each in ray order and
  randomly permuted: dx bitwise the parent's (and each right probe's),
  within 1e-4 of the plain version, a permuted batch's dx the permuted
  dx; times in turns (parent, new, probes, probes reversed, new,
  parent) and each shape's bound; and bitwise the parent's at d = 2 and
  5 (the GPU tests' metas);
- B1 want_g at the F=4 NeuS train step's 147,456 points × 2 levels
  (4221 rows), ray order and permuted: y and the words bitwise the
  parent's, the words equal to the plain version's, y within 1e-5 of it
  and the same bits as the y-only form's; times in turns with the
  probes; the y-only form at its row's 589,824 points (ray order and
  permuted) and on the recorded inputs of each of the F=4 render's six
  launches, parent and new in turns, y bitwise the parent's;
- inside the paths, with the wrapper (`permuto_cell._dydx_cuda`,
  `lotd_brick4._fwd_cuda`) routed to the parent's or the new library in
  turns (torch.profiler, ms per pass over three passes): B13 in path D's
  render (1 launch), in its train step (1) and in the field phase's
  split nablas (`PermutoSDF.forward_sdf_nablas`, 1); B1 want_g in the
  F=4 autograd nablas (`forward_sdf` with x requiring grad, 1 want_g
  launch and B2) and B1 in the F=4 render (six y-only launches); the
  kernel's device time and the pass's in each, and the pass's outputs
  bitwise equal between the two libraries.

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

# ------------------------------------------------ B13 (permuto_cell.cu)
B13_HEAD = """n - p0);
  const int l = threadIdx.x >> 5, i = threadIdx.x & 31;"""
X_LANE = "    for (int a = 0; a < D; ++a) xp[a] = x[(p0 + i) * D + a];"
G_LANE = "    const float2 g = g_up[(p0 + i) * L + l];"
B13_SMEM = ("    const size_t smem = sizeof(float) * PC_POINTS * L * "
            "(2 * d + 1);")
# the staged probes' x and g_up after the rank tables
STAGED_SMEM = (B13_SMEM[:-1] + " +\n                        sizeof(float) "
               "* PC_POINTS * (d + 2 * L);")
STAGED = """
  float2* gs = (float2*)(hs + (D + 1) * blockDim.x);   // [32, L]
  float* xs = (float*)(gs + PC_POINTS * L);            // [32, D]"""
STAGE_X = """
  for (int k = threadIdx.x; k < np * D; k += blockDim.x)
    xs[k] = x[p0 * D + k];"""
STAGE_G = """
  for (int k = threadIdx.x; k < np * L; k += blockDim.x)
    gs[k] = g_up[p0 * L + k];"""


def _staged(x: bool, g: bool) -> list:
    loops = (STAGE_X if x else "") + (STAGE_G if g else "")
    subs = [(B13_HEAD, B13_HEAD.replace(
        "n - p0);", "n - p0);" + STAGED + loops + "\n  __syncthreads();")),
        (B13_SMEM, STAGED_SMEM)]
    if x:
        subs.append((X_LANE, X_LANE.replace("x[(p0 + i) * D + a]",
                                            "xs[i * D + a]")))
    if g:
        subs.append((G_LANE, G_LANE.replace("g_up[(p0 + i) * L + l]",
                                            "gs[i * L + l]")))
    return subs


TERMS = ("    elevation_terms<D>(s, gf, meta, hs + threadIdx.x, blockDim.x, "
         "t);")
B13_LOAD = """      const float2 v = __ldg(table + s.vtx[k]);
      gf[k] = __fmaf_rn("""
NO_LOAD = B13_LOAD.replace("__ldg(table + s.vtx[k])",
                           "make_float2((float)s.vtx[k], 1.f)")
PC = "permuto_cell.cu"
B4F = "brick4.cu"
# ------------------------------------------------------ B1 (brick4.cu)
POINT_MAJOR = "  const int t = threadIdx.x, i = t / L, l = t - i * L;"
B1_Y = "    y[p0 * L + t] = make_float4(acc[0], acc[1], acc[2], acc[3]);"
B1_SYNC = "  __syncthreads();\n  // uint4 f = j * 32 L + t"
WS_STORE = """      ws[i * rec + l * 4 + q] = make_uint4(v[2 * q].x, v[2 * q].y,
                                           v[2 * q + 1].x, v[2 * q + 1].y);"""
WS_OUT = "    if (pi < np) out[j * 32 * L + t] = ws[pi * rec + tr];"
WS_DECL = "  extern __shared__ uint4 ws[];\n  const int L = meta.n_levels;"
PROBES = {
    "pc_stage_x": (PC, _staged(True, False)),
    "pc_stage_g": (PC, _staged(False, True)),
    "pc_stage_xg": (PC, _staged(True, True)),
    "pc_selects": (PC, [(TERMS, """    for (int a = 0; a < D; ++a) t[a] = 0.f;
    elevation_vjp<D>(s, gf, meta, meta.lv[l], t);""")]),
    "pc_noloads": (PC, [(B13_LOAD, NO_LOAD)]),
    "pc_search": (PC, [(B13_LOAD, NO_LOAD), (TERMS, """#pragma unroll
    for (int a = 0; a < D; ++a) t[a] = __fmul_rn(s.bary[a], gf[a]);""")]),
    "b4_level_major": (B4F, [
        (WS_DECL, WS_DECL.replace(
            "\n", "\n  __shared__ float4 ys[BRICK4_POINTS * "
            "BRICK4_MAX_LEVELS];\n")),
        (POINT_MAJOR, "  const int t = threadIdx.x, l = t >> 5, i = t & 31;"),
        (B1_Y, B1_Y.replace("y[p0 * L + t]", "ys[i * L + l]")),
        (B1_SYNC, B1_SYNC.replace(
            "\n", "\n  if (t < np * L) y[p0 * L + t] = ys[t];\n"))]),
    "b4_lane_words": (B4F, [
        ("    for (int q = 0; q < 4; ++q)\n" + WS_STORE,
         "    for (int k = 0; k < 8; ++k)\n"
         "      reinterpret_cast<uint2*>(words)[((p0 + i) * L + l) * 8 + k]"
         " = v[k];"),
        (WS_OUT, "    (void)out;")]),
    "b4_nowords": (B4F, [(WS_OUT, WS_OUT.replace(
        "if (pi < np)", "if (pi < np && ws[pi * rec + tr].x == 12345u)"))]),
}
PC_NAMES = ("pc_parent", "pc_new",
            *(k for k in PROBES if k.startswith("pc_")))
B4_NAMES = ("b4_parent", "b4_new",
            *(k for k in PROBES if k.startswith("b4_")))
# the probes whose outputs are right
PC_EXACT = ("pc_new", "pc_stage_x", "pc_stage_g", "pc_stage_xg")
B4_EXACT = ("b4_new", "b4_level_major", "b4_lane_words")
B13 = "permuto_dydx_kernel"
B1 = "brick4_fwd"
UNCHANGED = {"pc": ("permuto_fwd_kernel", "permuto_bwd_kernel"),
             "b4": ("brick4_fwd_kernel", "brick4_bwd_kernel",
                    "brick4_dydx_kernel", "brick4_bwd2_kernel"),
             "p4": ("",)}          # every kernel of permuto_cell4.cu


def _probe(name: str, fname: str, subs) -> tuple:
    """A copy of this tree's sources in BUILD/name with each (old, new) of
    `subs` replaced in `fname` (each old text must occur once); (the
    copy's source, its -I dir)."""
    out = BUILD / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(NEW, out)
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
    registers of B13's and B1's instances."""
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
            elif "registers" in line and (B13 in entry or B1 in entry):
                print(f"[ptxas {name}] {entry[:48]}: {line.strip()}")


def _build() -> dict:
    parent = Path(sys.argv[1]).resolve()
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = {}
    for tag, fname in (("pc", PC), ("b4", B4F), ("p4", "permuto_cell4.cu")):
        sources[f"{tag}_parent"] = (parent / fname, parent)
        sources[f"{tag}_new"] = (NEW / fname, NEW)
    sources.update({name: _probe(name, fname, subs)
                    for name, (fname, subs) in PROBES.items()})
    _nvcc_all(sources)
    return {name: BUILD / f"lib{name}.so" for name in sources}


def _load(path: Path) -> ctypes.CDLL:
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4
    from nr3d_lib_tpu_torch.ops import permuto_cell as PCM

    vp, n = ctypes.c_void_p, ctypes.c_longlong
    lib = ctypes.CDLL(str(path))
    if path.name.startswith("libpc"):
        lib.permuto_dydx.argtypes = [vp, vp, vp, PCM._Meta, vp, n, vp]
        lib.permuto_dydx.restype = ctypes.c_int
    elif path.name.startswith("libb4"):
        lib.brick4_fwd.argtypes = [vp, vp, B4._Meta, vp, vp, n, vp]
        lib.brick4_fwd.restype = ctypes.c_int
    return lib


def _dydx(lib, g_up, x, table, meta):
    """B13 of one library → dx [N, d]."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import permuto_cell as PCM

    dx = torch.empty_like(x)
    Bu.check(lib.permuto_dydx(g_up.data_ptr(), x.data_ptr(),
                              table.data_ptr(), PCM.c_meta(meta),
                              dx.data_ptr(), x.shape[0],
                              Bu.stream_ptr(x.device)), "permuto_dydx")
    return dx


def _fwd(lib, x, packed, meta, want_g=False):
    """B1 of one library → y [N,4L], or (y, words [N,L,8,2] int32)."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    n, L = x.shape[0], meta.n_levels
    y = torch.empty(n, 4 * L, device=x.device)
    w = torch.empty(n, L, 8, 2, device=x.device,
                    dtype=torch.int32) if want_g else None
    Bu.check(lib.brick4_fwd(x.data_ptr(), packed.data_ptr(),
                            B4.c_meta(meta, B4._Meta), y.data_ptr(),
                            B4.ptr(w), n, Bu.stream_ptr(x.device)),
             "brick4_fwd")
    return (y, w) if want_g else y


def _turns(fns: dict, order) -> dict:
    import chip_smoke as CS

    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(CS._time_ms(fns[k]))
    return ms


def _same(res: dict, key: str, a, b) -> None:
    import torch

    res[key] = bool(torch.equal(a, b))


def _models(dev):
    """`chip_smoke.py`'s F=4 NeuS, path D model and 3D `PermutoSDF`,
    seeded as it seeds them."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.models.fields.sdf import PermutoSDF
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel
    from nr3d_lib_tpu_torch.models.model_families import \
        DynamicPermutoNeuSModel

    f4 = LoTDNeuSModel(**CS.PROD_CFG, seed=0)
    CS._seed_weights(f4, f4.field.implicit_surface.encoding, 1)
    f4.populate()
    CS._seed_occupancy(f4)
    pathd = DynamicPermutoNeuSModel(**CS.PATHD_CFG, seed=0)
    CS._seed_weights(pathd, pathd.field.implicit_surface.bank, 7)
    pathd.populate()
    sdf = PermutoSDF(permuto_cfg=CS.FIELD_PERMUTO, seed=0, device=dev)
    p = sdf.bank.flattened_params
    with torch.no_grad():
        p.copy_(torch.from_numpy(np.random.default_rng(10).uniform(
            -0.1, 0.1, tuple(p.shape)).astype(np.float32)))
    return f4, pathd, sdf


def _rays(dev):
    import torch
    import chip_smoke as CS

    o, d = (torch.from_numpy(a).to(dev) for a in CS._rays(CS.N_RAYS, seed=0))
    ts = torch.from_numpy(np.random.default_rng(6).uniform(
        -1.0, 1.0, CS.N_RAYS).astype(np.float32)).to(dev)
    return o, d, ts


def _b13_shape(libs: dict, x, g, table, meta) -> dict:
    """B13 on the points x, in ray order and permuted: bits and times in
    turns."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import permuto_cell as PCM

    dev, n, L, dim = x.device, x.shape[0], meta.n_levels, meta.n_dims
    perm = torch.randperm(n, device=dev,
                          generator=torch.Generator(dev).manual_seed(5))
    r = {"n": n, "d": dim, "levels": L, "rows": meta.total_rows}
    plain = PCM.permuto_cell_nablas_xla(g, x, table, meta)
    for order, xx, gg in (("ray", x, g),
                          ("permuted", x[perm].contiguous(),
                           g[perm].contiguous())):
        out = {m: _dydx(libs[m], gg, xx, table, meta)
               for m in ("pc_parent", *PC_EXACT)}
        for m in PC_EXACT:
            _same(r, f"{order}_{m}_bitwise_vs_parent", out[m],
                  out["pc_parent"])
        if order == "ray":
            ray_dx = out["pc_new"]
            r["dx_err"] = float((ray_dx - plain).abs().max())
            r["dx_tol"] = 1e-4 + 1e-4 * float(plain.abs().max())
        else:
            _same(r, "permuted_dx_is_the_permuted_dx", out["pc_new"],
                  ray_dx[perm])
        r[f"{order}_ms"] = _turns(
            {m: (lambda m=m, a=xx, b=gg: _dydx(libs[m], b, a, table, meta))
             for m in PC_NAMES}, PC_NAMES + PC_NAMES[::-1])
    r["bound_ms"], r["bound_by"] = CS._b13_bound(n, dim, L,
                                                  table.numel() * 4)
    return r


def _b13(libs: dict, dev, pathd, sdf) -> dict:
    """B13 at its rows' shapes, and its bits at d = 2 and 5."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import permuto_cell as PCM

    o, d, ts = _rays(dev)
    res = {}
    with torch.no_grad():
        for key, bank, x in (
                ("path_d", pathd.field.implicit_surface.bank,
                 CS._dyn_points(o, d, ts, 96, seed=26)),
                ("lattice_3d", sdf.bank, CS._ray_points(o, d, 96, seed=27))):
            meta = bank.meta
            g = torch.randn(x.shape[0], 2 * meta.n_levels, device=dev,
                            generator=torch.Generator(dev).manual_seed(28))
            res[key] = _b13_shape(libs, x, g, bank.flattened_params.detach(),
                                  meta)
            print(f"[B13 {key}] {json.dumps(res[key])}")
        # the GPU tests' other dimensions: bits only
        for dim, lod in ((2, [4.0, 12.0, 40.0]), (5, [2.0, 6.0, 18.0])):
            meta = PCM.make_permuto_cell_meta(dim, lod, 4096)
            rng = np.random.default_rng(dim)
            x = torch.from_numpy(rng.uniform(
                0.0, 1.0, (96 * 1001, dim)).astype(np.float32)).to(dev)
            table = torch.from_numpy(rng.uniform(
                -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(dev)
            g = torch.from_numpy(rng.normal(size=(x.shape[0], 2 * len(lod)))
                                 .astype(np.float32)).to(dev)
            _same(res, f"d{dim}_bitwise_vs_parent",
                  _dydx(libs["pc_new"], g, x, table, meta),
                  _dydx(libs["pc_parent"], g, x, table, meta))
    return res


def _b1(libs: dict, dev, f4) -> dict:
    """B1 want_g at the F=4 step's points and B1 y only at its row's, ray
    order and permuted; B1 on each of the F=4 render's six launches."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    o, d, _ = _rays(dev)
    enc = f4.field.implicit_surface.encoding
    meta, table = enc.meta, enc._build_table().detach()
    packed = B4.pack_table4(table)
    two = ("b4_parent", "b4_new")
    res = {}
    with torch.no_grad():
        for key, x, want_g in (("want_g", CS._ray_points(o, d, 36, seed=3),
                                True),
                               ("y_only", CS._ray_points(o, d, 144, seed=2),
                                False)):
            n = x.shape[0]
            perm = torch.randperm(n, device=dev, generator=torch.Generator(
                dev).manual_seed(7))
            r = {"n": n, "levels": meta.n_levels, "rows": meta.total_rows}
            names = B4_NAMES if want_g else two
            exact = B4_EXACT if want_g else ("b4_new",)
            for order, xx in (("ray", x), ("permuted", x[perm].contiguous())):
                out = {m: _fwd(libs[m], xx, packed, meta, True)
                       for m in ("b4_parent", *exact)}
                y_only = {m: _fwd(libs[m], xx, packed, meta) for m in two}
                _same(r, f"{order}_y_bitwise_vs_parent", y_only["b4_new"],
                      y_only["b4_parent"])
                for m in exact:
                    _same(r, f"{order}_{m}_want_g_y_bitwise_vs_parent",
                          out[m][0], out["b4_parent"][0])
                    _same(r, f"{order}_{m}_words_equal_parent", out[m][1],
                          out["b4_parent"][1])
                    _same(r, f"{order}_{m}_y_same_in_both_forms", out[m][0],
                          y_only["b4_new"])
                if order == "ray":
                    ray = out["b4_new"]
                    y_plain = B4.brick4_encode_xla(x, table, meta)
                    r["y_err"] = float((ray[0] - y_plain).abs().max())
                    r["y_tol"] = 1e-5 + 1e-5 * float(y_plain.abs().max())
                    _same(r, "words_equal_plain", ray[1],
                          B4.brick4_corner_words_xla(x, table, meta))
                else:
                    _same(r, "permuted_y_is_the_permuted_y",
                          out["b4_new"][0], ray[0][perm])
                    _same(r, "permuted_words_are_the_permuted_words",
                          out["b4_new"][1], ray[1][perm])
                r[f"{order}_ms"] = _turns(
                    {m: (lambda m=m, a=xx: _fwd(libs[m], a, packed, meta,
                                                want_g)) for m in names},
                    names + names[::-1])
            r["bound_ms"], r["bound_by"] = (
                CS._b1_want_g_bound(n, meta.n_levels, packed.numel() * 4)
                if want_g else CS._bound(n * (12 + 16 * meta.n_levels) +
                                         packed.numel() * 4,
                                         n * meta.n_levels * 92))
            res[key] = r
            print(f"[B1 {key}] {json.dumps(r)}")
        launches = []
        for args, kw in CS._render_fwd_calls(f4, o, d, B4):
            x, pk, mt = args[:3]
            r = {"n": int(x.shape[0]),
                 "form": "want_g" if kw.get("want_g") else "y"}
            _same(r, "y_bitwise_vs_parent", _fwd(libs["b4_new"], x, pk, mt),
                  _fwd(libs["b4_parent"], x, pk, mt))
            r["ms"] = _turns({m: (lambda m=m: _fwd(libs[m], x, pk, mt))
                              for m in two}, two + two[::-1])
            launches.append(r)
            print(f"[B1 render launch {len(launches) - 1}] {json.dumps(r)}")
        res["render_launches"] = launches
    return res


def _in_path(libs: dict, module, attr: str, call, kernel: str, run) -> dict:
    """The kernel's device time and the pass's inside `run()` (three passes
    under torch.profiler), with `module.attr` routed by `call(lib, ...)`
    to the parent's or the new library in turns; and whether the passes'
    outputs are the same bits under both."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    orig, out, outputs = getattr(module, attr), {}, {}
    tag = "pc" if attr == "_dydx_cuda" else "b4"
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


def _paths(libs: dict, dev, f4, pathd, sdf) -> dict:
    """B13 inside path D's render and train step and the field's split
    nablas; B1 want_g inside the F=4 autograd nablas, B1 inside the F=4
    render."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4
    from nr3d_lib_tpu_torch.ops import permuto_cell as PCM

    o, d, ts = _rays(dev)
    extra = {"ts": ts}

    def dydx(lib, g_up, x, table, meta):
        return _dydx(lib, PCM.aligned(g_up), PCM.aligned(x),
                     PCM.aligned(table), meta)

    def fwd(lib, x, packed, meta, want_g=False):
        return _fwd(lib, B4.aligned(x), packed, meta, want_g)

    def render(model, ext=None):
        def go():
            with torch.no_grad():
                rendered, _ = model.ray_query(CS._tested(model, o, d, ext))
            return {k: v for k, v in rendered.items()
                    if isinstance(v, torch.Tensor)}
        return go

    def step():
        g = torch.Generator(device=dev).manual_seed(9)
        pathd.training_before_per_step(1, g)
        with torch.enable_grad():
            loss = CS._step_loss(pathd, o, d, extra, generator=g)
            loss.backward()
        pathd.zero_grad(set_to_none=True)
        return {"loss": loss.detach()}

    x3 = CS._ray_points(o, d, 96, seed=29) * 2.0 - 1.0

    def split_nablas():
        with torch.no_grad():
            return {"nablas": sdf.forward_sdf_nablas(x3)["nablas"]}

    x4 = (CS._ray_points(o, d, 36, seed=3) * 2.0 - 1.0).detach()

    def autograd_nablas():
        xr = x4.clone().requires_grad_(True)
        (nab, ) = torch.autograd.grad(f4.forward_sdf(xr)["sdf"].sum(), xr)
        return {"nablas": nab}

    res = {}
    for key, module, attr, call, kernel, run in (
            ("b13_path_d_render", PCM, "_dydx_cuda", dydx, B13,
             render(pathd, extra)),
            ("b13_path_d_step", PCM, "_dydx_cuda", dydx, B13, step),
            ("b13_field_split_nablas", PCM, "_dydx_cuda", dydx, B13,
             split_nablas),
            # the parent's want_g form is its y-only kernel: both names
            # hold B1
            ("b1_want_g_f4_autograd_nablas", B4, "_fwd_cuda", fwd, B1,
             autograd_nablas),
            ("b1_f4_render", B4, "_fwd_cuda", fwd, B1, render(f4))):
        res[key] = _in_path(libs, module, attr, call, kernel, run)
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

    if len(sys.argv) != 2 or not Path(sys.argv[1], PC).is_file():
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
                           if B13 in k or B1 in k}
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
    libs = {n: _load(p) for n, p in paths.items() if not n.startswith("p4")}
    f4, pathd, sdf = _models(dev)
    res["b13"] = _b13(libs, dev, pathd, sdf)
    res["b1"] = _b1(libs, dev, f4)
    res["paths"] = _paths(libs, dev, f4, pathd, sdf)
    res["failed"] = _check(res)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
