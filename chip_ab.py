#!/usr/bin/env python3
"""Time the parent commit's cell permuto kernels (B10–B16) against this
tree's, in turns, on one card, and compare their outputs.

    git archive <parent> nr3d_lib_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_ab.py _archive/parent/nr3d_lib_tpu_torch/csrc

(`_archive/` is listed in `.gitignore`; run the second line where the
card is.) Builds, with the port's nvcc flags, into `_archive/ab_build/`,
one nvcc per library, all started together: the parent's
`permuto_cell4.cu` and `permuto_cell.cu` (each with the parent's
`permuto_simplex.cuh`), this tree's, four probes made from this tree's
`permuto_cell4.cu` by text substitution, and a probe kernel around one
`find_simplex` of each header, whose SASS (`cuobjdump -sass`) gives the
search's instruction count. The probes: B14 without its table loads
(`pc4_noloads`: wrong outputs, the loads' cost); B15 without its atomics
(`pc4_noatomics`: each group's sum goes to a register sink that is never
stored, so wrong gradients, the atomics' and the aggregation's cost);
B15 with one atomic per lane (`pc4_lane_atomics`: the aggregation off);
B15 with a butterfly sum for a warp whose lanes all add to one slot
(`pc4_fastpath`). Prints each library's ptxas registers, then, at path
C's 393,216 (x,t) points (`chip_smoke._dyn_points`, the dynamic NeuS's
4D meta, 14,080 rows) in ray order and randomly permuted:

- B14: bitwise equality with the parent, times in turns (parent, new,
  probe, probe, new, parent);
- B15 without and with dL/dx: dL/dtable and dL/dx against the plain
  version (tolerances of `chip_smoke.py`), dL/dx bitwise equal between
  the two orders, dL/dtable's distance to a float64 sum of the same
  contributions (the plain version's, and five runs each of the
  parent's, the new and the one-atomic-a-lane kernels'), the atomics
  issued with and without aggregation
  (`ops/permuto_cell.atomic_groups`), times in turns (parent, new,
  probes, probes reversed, new, parent);
- B16: bitwise equality with the parent, times in turns;

and, at path D's 393,216 (x,t) points (five hashed levels) and the 3D
lattice's 393,216 points (eight levels, one dense), the F=2 kernels whose
only change is the shared header: B10 and B13 bitwise against the
parent, B11 and B12 within their tolerances of the plain version, times
in turns (parent, new, new, parent).

The last line of its output is one JSON object with every number. It
exits 1 if a comparison failed (the JSON's "failed" names it).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BUILD = REPO / "_archive" / "ab_build"
NEW = REPO / "nr3d_lib_tpu_torch" / "csrc"

LOAD4 = "      unpack4(__ldg(table + s.vtx[k]), f);"
NO_LOAD4 = """      f[0] = (float)s.vtx[k];
      f[1] = f[2] = f[3] = 1.f;"""
# the body of warp_add4, from its first line to its last
AGG_FIRST = "  const unsigned peers = __match_any_sync(active, key);"
AGG_LAST = "  if (below == 0u) atomic_add4(dst + key, v);"
NO_ATOMICS = "  if (v.x == 1.0e38f && v.y == -1.0e38f) atomic_add4(dst + key, v);"
LANE_ATOMICS = "  atomic_add4(dst + key, v);"
# a fast path for a warp whose 32 lanes all add to one slot: a butterfly
# sum (5 rounds of shuffles) in place of the tree over the group's ranks
FAST_PATH = AGG_FIRST + """
  if (peers == 0xffffffffu) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = make_float4(v.x + __shfl_xor_sync(peers, v.x, o),
                      v.y + __shfl_xor_sync(peers, v.y, o),
                      v.z + __shfl_xor_sync(peers, v.z, o),
                      v.w + __shfl_xor_sync(peers, v.w, o));
    if ((threadIdx.x & 31u) == 0u) atomic_add4(dst + key, v);
    return;
  }"""
SIMPLEX_PROBE = """#include "permuto_simplex.cuh"

// one find_simplex<D> a thread, at the level of blockIdx.y
template <int D>
__global__ void simplex_probe(const float* __restrict__ x,
                              const __grid_constant__ PCMeta meta,
                              int* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float xp[D];
#pragma unroll
  for (int a = 0; a < D; ++a) xp[a] = x[i * D + a];
  Simplex<D> s;
  find_simplex<D>(xp, meta, meta.lv[blockIdx.y], s);
  int acc = 0;
#pragma unroll
  for (int k = 0; k <= D; ++k)
    acc += (int)s.vtx[k] ^ __float_as_int(s.bary[k]);
  out[i] = acc;
}

extern "C" void simplex_probe_launch(const float* x, PCMeta meta, int* out) {
  simplex_probe<3><<<1, 32>>>(x, meta, out, 0);
  simplex_probe<4><<<1, 32>>>(x, meta, out, 0);
}
"""


class _ParentLevel(ctypes.Structure):
    """The parent's `PCLevel` (before the per-level modulus)."""
    _fields_ = [("scale", ctypes.c_float * 5), ("box_lo", ctypes.c_int * 5),
                ("box_dims", ctypes.c_int * 5), ("n_rows", ctypes.c_int),
                ("row_offset", ctypes.c_int), ("is_dense", ctypes.c_int)]


class _ParentMeta(ctypes.Structure):
    _fields_ = [("n_dims", ctypes.c_int), ("n_levels", ctypes.c_int),
                ("cells_per_row", ctypes.c_int),
                ("sf", ctypes.c_float * 5), ("lv", _ParentLevel * 16)]


def _parent_meta(meta) -> _ParentMeta:
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    new, old = PC.c_meta(meta), _ParentMeta()
    for f, _ in _ParentMeta._fields_[:4]:
        setattr(old, f, getattr(new, f))
    for i in range(16):
        for f, _ in _ParentLevel._fields_:
            setattr(old.lv[i], f, getattr(new.lv[i], f))
    return old


def _substituted(src: Path, old: str, new: str, name: str) -> Path:
    text = src.read_text()
    if old not in text:
        raise RuntimeError(f"{src.name}: the text {name} replaces is not "
                           f"in it")
    out = BUILD / f"{name}.cu"
    out.write_text(text.replace(old, new, 1))     # the first: the forward's
    return out


def _agg_body(src: Path) -> str:
    text = src.read_text()
    a, b = text.index(AGG_FIRST), text.index(AGG_LAST) + len(AGG_LAST)
    return text[a:b]


def _nvcc_all(sources: dict) -> None:
    """One nvcc per library, all started together; prints ptxas'
    registers."""
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
            elif "registers" in line:
                print(f"[ptxas {name}] {entry[:60]}: {line.strip()}")


def _sass_counts(lib: Path) -> dict:
    """Instructions (NOPs aside) of each function in the library's SASS."""
    from nr3d_lib_tpu_torch.ops import _build as B

    cuobjdump = Path(B._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line) and \
                "NOP" not in line:
            counts[name] += 1
    return counts


def _build() -> dict:
    parent = Path(sys.argv[1]).resolve()
    BUILD.mkdir(parents=True, exist_ok=True)
    pc4, pc = NEW / "permuto_cell4.cu", NEW / "permuto_cell.cu"
    body = _agg_body(pc4)
    for name in ("simplex_parent", "simplex_new"):
        (BUILD / f"{name}.cu").write_text(SIMPLEX_PROBE)
    sources = {
        "pc4_parent": (parent / "permuto_cell4.cu", parent),
        "pc4_new": (pc4, NEW),
        "pc4_noloads": (_substituted(pc4, LOAD4, NO_LOAD4, "pc4_noloads"),
                        NEW),
        "pc4_noatomics": (_substituted(pc4, body, NO_ATOMICS,
                                       "pc4_noatomics"), NEW),
        "pc4_lane_atomics": (_substituted(pc4, body, LANE_ATOMICS,
                                          "pc4_lane_atomics"), NEW),
        "pc4_fastpath": (_substituted(pc4, AGG_FIRST, FAST_PATH,
                                      "pc4_fastpath"), NEW),
        "pc_parent": (parent / "permuto_cell.cu", parent),
        "pc_new": (pc, NEW),
        "simplex_parent": (BUILD / "simplex_parent.cu", parent),
        "simplex_new": (BUILD / "simplex_new.cu", NEW),
    }
    _nvcc_all(sources)
    return {name: BUILD / f"lib{name}.so" for name in sources}


def _load(path: Path, parent: bool) -> ctypes.CDLL:
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    vp, n = ctypes.c_void_p, ctypes.c_longlong
    meta = _ParentMeta if parent else PC._Meta
    lib = ctypes.CDLL(str(path))
    for prefix in ("permuto4", "permuto"):
        if hasattr(lib, f"{prefix}_fwd"):
            for fn, types in ((f"{prefix}_fwd", [vp, vp, meta, vp, n, vp]),
                              (f"{prefix}_bwd",
                               [vp, vp, vp, meta, vp, vp, n, vp]),
                              (f"{prefix}_dydx",
                               [vp, vp, vp, meta, vp, n, vp])):
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
            break
    return lib


def _turns(fns: dict, order) -> dict:
    import chip_smoke as CS

    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(CS._time_ms(fns[k]))
    return ms


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


class _Kernels:
    """The F-feature cell kernels of one library, called as the wrappers
    call them."""

    def __init__(self, lib, parent: bool, f4: bool, dev):
        self.lib, self.parent, self.dev = lib, parent, dev
        self.pre, self.nf = ("permuto4", 4) if f4 else ("permuto", 2)

    def meta(self, meta):
        from nr3d_lib_tpu_torch.ops import permuto_cell as PC

        return _parent_meta(meta) if self.parent else PC.c_meta(meta)

    def fwd(self, x, table, meta):
        import torch
        from nr3d_lib_tpu_torch.ops import _build as B

        y = torch.empty(x.shape[0], self.nf * meta.n_levels, device=self.dev)
        B.check(getattr(self.lib, f"{self.pre}_fwd")(
            x.data_ptr(), table.data_ptr(), self.meta(meta), y.data_ptr(),
            x.shape[0], B.stream_ptr(self.dev)), "fwd")
        return y

    def bwd(self, x, g, table, meta, need_dx):
        import torch
        from nr3d_lib_tpu_torch.ops import _build as B

        dtab = torch.empty(meta.total_rows, 64 * self.nf, device=self.dev)
        dx = torch.empty_like(x) if need_dx else None
        B.check(getattr(self.lib, f"{self.pre}_bwd")(
            x.data_ptr(), g.data_ptr(), table.data_ptr() if need_dx else None,
            self.meta(meta), dtab.data_ptr(),
            dx.data_ptr() if need_dx else None, x.shape[0],
            B.stream_ptr(self.dev)), "bwd")
        return dx, dtab

    def dydx(self, g, x, table, meta):
        import torch
        from nr3d_lib_tpu_torch.ops import _build as B

        dx = torch.empty_like(x)
        B.check(getattr(self.lib, f"{self.pre}_dydx")(
            g.data_ptr(), x.data_ptr(), table.data_ptr(), self.meta(meta),
            dx.data_ptr(), x.shape[0], B.stream_ptr(self.dev)), "dydx")
        return dx


def _inputs(dev, meta, x, width: int, seed: int):
    import torch

    table = torch.from_numpy(np.random.default_rng(seed).uniform(
        -0.1, 0.1, (meta.total_rows, width)).astype(np.float32)).to(dev)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    n_out = (width // 64) * meta.n_levels
    g = torch.randn(x.shape[0], n_out, device=dev, generator=gen)
    gd = torch.randn(x.shape[0], meta.n_dims, device=dev, generator=gen)
    perm = torch.randperm(x.shape[0], device=dev,
                          generator=torch.Generator(dev).manual_seed(5))
    return table, g, gd, perm


def _f4(libs: dict, dev) -> dict:
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC
    from nr3d_lib_tpu_torch.ops import permuto_cell4 as P4

    meta = PC.make_permuto_cell_meta(4, [4.0, 11.0, 32.0, 90.0], 4096)
    o, d = (torch.from_numpy(a).to(dev) for a in CS._rays(CS.N_RAYS, seed=0))
    ts = torch.from_numpy(np.random.default_rng(6).uniform(
        -1.0, 1.0, CS.N_RAYS).astype(np.float32)).to(dev)
    x = CS._dyn_points(o, d, ts, 96, seed=16)
    table, g, _, perm = _inputs(dev, meta, x, 256, 7)
    packed = P4.pack_table4(table)
    k = {n: _Kernels(libs[n], n.endswith("parent"), True, dev)
         for n in libs}
    n = x.shape[0]
    res = {"n": n, "rows": meta.total_rows,
           "atomics_naive": n * meta.n_levels * (meta.n_dims + 1)}
    with torch.no_grad():
        dx_p, dtab_p = P4.permuto_cell4_encode_bwd_xla(x, table, g, meta, True)
        # dL/dtable in float64 from the same float32 weights: how far each
        # float32 sum (the plain version's and the kernels' atomics) lies
        # from the exact one
        ref = torch.zeros(meta.total_rows * 64, 4, dtype=torch.float64,
                          device=dev)
        for l, lv in enumerate(meta.levels):
            vtx, bary, _ = PC._level_vertices(x, lv, meta)
            ref.index_add_(0, vtx.reshape(-1), (
                bary[..., None].double() *
                g[:, None, 4 * l:4 * l + 4].double()).reshape(-1, 4))
        ref = ref.view(meta.total_rows, 256)
        res["b15_ray_dtab_vs_f64"] = {"plain": float(
            (dtab_p.double() - ref).abs().max())}
        for m in ("pc4_parent", "pc4_new", "pc4_lane_atomics"):
            res["b15_ray_dtab_vs_f64"][m] = [float(
                (k[m].bwd(x, g, packed, meta, False)[1].double() - ref)
                .abs().max()) for _ in range(5)]
        del ref
        orders = (("ray", x, g), ("permuted", x[perm].contiguous(),
                                  g[perm].contiguous()))
        for order, xx, gg in orders:
            groups = PC.atomic_groups(xx, meta)
            res[f"{order}_atomic_groups"] = sum(groups)
            res[f"{order}_atomic_groups_by_level"] = groups
            # (warp, vertex) pairs whose 32 lanes all add to one slot
            res[f"{order}_whole_warp_groups_by_level"] = [
                int((v.view(-1, 32, v.shape[1]) == v.view(-1, 32, v.shape[1])
                     [:, :1]).all(1).sum())
                for v in (PC._level_vertices(xx, lv, meta)[0]
                          for lv in meta.levels)]
            # B14
            y_new = k["pc4_new"].fwd(xx, packed, meta)
            res[f"b14_{order}_bitwise_vs_parent"] = bool(torch.equal(
                y_new, k["pc4_parent"].fwd(xx, packed, meta)))
            names = ("pc4_parent", "pc4_new", "pc4_noloads")
            res[f"b14_{order}_ms"] = _turns(
                {m: (lambda m=m: k[m].fwd(xx, packed, meta)) for m in names},
                names + names[::-1])
            # B15
            want_dx = dx_p if order == "ray" else dx_p[perm]
            want_tab = dtab_p
            for need_dx in (False, True):
                tag = f"b15{'_dx' if need_dx else ''}_{order}"
                dxk, dtab = k["pc4_new"].bwd(xx, gg, packed, meta, need_dx)
                res[f"{tag}_dtab_err"] = float((dtab - want_tab).abs().max())
                res[f"{tag}_dtab_tol"] = 1e-6 + 1e-5 * float(
                    want_tab.abs().max())
                if need_dx:
                    res[f"{tag}_dx_err"] = float((dxk - want_dx).abs().max())
                    res[f"{tag}_dx_tol"] = 1e-4 + 1e-4 * float(
                        want_dx.abs().max())
                    res[f"b15_dx_{order}"] = dxk
                for probe in ("lane_atomics", "fastpath"):
                    _, dt = k[f"pc4_{probe}"].bwd(xx, gg, packed, meta,
                                                  need_dx)
                    res[f"{tag}_{probe}_dtab_err"] = float(
                        (dt - want_tab).abs().max())
                names = ("pc4_parent", "pc4_new", "pc4_noatomics",
                         "pc4_lane_atomics", "pc4_fastpath")
                res[f"{tag}_ms"] = _turns(
                    {m: (lambda m=m: k[m].bwd(xx, gg, packed, meta, need_dx))
                     for m in names}, names + names[::-1])
            # B16
            res[f"b16_{order}_bitwise_vs_parent"] = bool(torch.equal(
                k["pc4_new"].dydx(gg, xx, packed, meta),
                k["pc4_parent"].dydx(gg, xx, packed, meta)))
            names = ("pc4_parent", "pc4_new")
            res[f"b16_{order}_ms"] = _turns(
                {m: (lambda m=m: k[m].dydx(gg, xx, packed, meta))
                 for m in names}, names + names[::-1])
        dx_ray, dx_perm = res.pop("b15_dx_ray"), res.pop("b15_dx_permuted")
        res["b15_dx_bitwise_between_orders"] = bool(torch.equal(
            dx_perm, dx_ray[perm]))
    return res


def _f2(libs: dict, dev) -> dict:
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    o, d = (torch.from_numpy(a).to(dev) for a in CS._rays(CS.N_RAYS, seed=0))
    ts = torch.from_numpy(np.random.default_rng(6).uniform(
        -1.0, 1.0, CS.N_RAYS).astype(np.float32)).to(dev)
    k = {n: _Kernels(libs[n], n.endswith("parent"), False, dev)
         for n in libs}
    res = {}
    names = ("pc_parent", "pc_new")
    order = names + names[::-1]
    for what, meta, x in (
            ("pathd", PC.make_permuto_cell_meta(
                4, [8.0, 16.0, 32.0, 64.0, 128.0], 4096),
             CS._dyn_points(o, d, ts, 96, seed=26)),
            ("3d", PC.make_permuto_cell_meta(
                3, [16.0 * 2 ** (0.5 * i) for i in range(8)], 4096),
             CS._ray_points(o, d, 96, seed=27))):
        table, g, _, perm = _inputs(dev, meta, x, 128, 7)
        with torch.no_grad():
            for o_name, xx in (("ray", x), ("permuted", x[perm].contiguous())):
                res[f"b10_{what}_{o_name}_bitwise_vs_parent"] = bool(
                    torch.equal(k["pc_new"].fwd(xx, table, meta),
                                k["pc_parent"].fwd(xx, table, meta)))
                res[f"b10_{what}_{o_name}_ms"] = _turns(
                    {m: (lambda m=m, xx=xx: k[m].fwd(xx, table, meta))
                     for m in names}, order)
            dx_p, dtab_p = PC.permuto_cell_encode_bwd_xla(x, table, g, meta,
                                                          True)
            for need_dx, tag in ((False, "b11"), (True, "b12")):
                dxk, dtab = k["pc_new"].bwd(x, g, table, meta, need_dx)
                res[f"{tag}_{what}_dtab_err"] = float(
                    (dtab - dtab_p).abs().max())
                res[f"{tag}_{what}_dtab_tol"] = 1e-6 + 1e-5 * float(
                    dtab_p.abs().max())
                if need_dx:
                    res[f"{tag}_{what}_dx_err"] = float(
                        (dxk - dx_p).abs().max())
                    res[f"{tag}_{what}_dx_tol"] = 1e-4 + 1e-4 * float(
                        dx_p.abs().max())
                res[f"{tag}_{what}_ms"] = _turns(
                    {m: (lambda m=m, nd=need_dx: k[m].bwd(x, g, table, meta,
                                                          nd))
                     for m in names}, order)
            res[f"b13_{what}_bitwise_vs_parent"] = bool(torch.equal(
                k["pc_new"].dydx(g, x, table, meta),
                k["pc_parent"].dydx(g, x, table, meta)))
            res[f"b13_{what}_ms"] = _turns(
                {m: (lambda m=m: k[m].dydx(g, x, table, meta))
                 for m in names}, order)
    return res


def _check(res: dict) -> list:
    """What the run must show; the names of what failed."""
    bad = []
    if res["f4"]["b15_dx_bitwise_between_orders"] is not True:
        bad.append("b15_dx_bitwise_between_orders")
    for part in ("f4", "f2"):
        for key, v in res[part].items():
            tol = res[part].get(key[:-4] + "_tol")
            if key.endswith("_err") and tol is not None and v > tol:
                bad.append(f"{part}.{key}")
            if key.endswith("bitwise_vs_parent") and v is not True:
                bad.append(f"{part}.{key}")
    return bad


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not Path(sys.argv[1], "permuto_cell4.cu") \
            .is_file():
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as CS

    dev = torch.device("cuda")
    smi = CS._smi()
    print(f"[device] {smi}")
    t0 = time.perf_counter()
    paths = _build()
    print(f"[build] {len(paths)} libraries: {time.perf_counter() - t0:.1f} s")
    res = {"device": smi, "sass": {}}
    for name in ("simplex_parent", "simplex_new", "pc4_parent", "pc4_new"):
        counts = _sass_counts(paths[name])
        res["sass"][name] = {f: c for f, c in counts.items()
                             if "simplex_probe" in f or "permuto4" in f}
    print(f"[sass] {json.dumps(res['sass'])}")
    libs = {n: _load(p, n.endswith("parent")) for n, p in paths.items()
            if not n.startswith("simplex")}
    res["f4"] = _f4({n: l for n, l in libs.items() if n.startswith("pc4")},
                    dev)
    print(f"[F=4] {json.dumps(res['f4'])}")
    res["f2"] = _f2({n: l for n, l in libs.items()
                     if n in ("pc_parent", "pc_new")}, dev)
    print(f"[F=2] {json.dumps(res['f2'])}")
    res["failed"] = _check(res)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
