#!/usr/bin/env python3
"""Time the parent commit's F=2 backward kernels against this tree's, in
turns, on one card, with probes, and compare their outputs: the cell
permuto's B11/B12 (`permuto_bwd`, `csrc/permuto_cell.cu`) and the brick
nablas' backward B9 (`brick_bwd2`, `csrc/brick.cu`).

    git archive <parent> nr3d_lib_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_ab.py _archive/parent/nr3d_lib_tpu_torch/csrc

(`_archive/` is listed in `.gitignore`; run the second line where the
card is.) Builds, with the port's nvcc flags, into `_archive/ab_build/`,
one nvcc per library, all started together, each source with its own
directory's headers (`-I`): the parent's and this tree's
`permuto_cell.cu` and `brick.cu`, and probes made by text substitution,
in lieu of `ncu`:

- `*_noatomics`: this tree's `warp_add2` (`warp_atomics.cuh`) sends each
  sum to a register sink that is never stored (wrong table gradients: the
  atomics' and the aggregation's cost);
- `*_lane_atomics`: `warp_add2` issues one atomic per lane (the
  aggregation off; for B9, the parent's atomics in this tree's thread per
  (point, level));
- `brick_parent_noatomics`: the parent's B9 without its atomics;
- `brick_parent_level0`: the parent's B9 at level 0 alone (its dense
  125 rows: are they the hot spot?);
- `brick_unfused`: this tree's B9 with its level sum of dL/dx written
  as a product and an add rounded apart, in place of the FMA: which of
  the two forms is the parent's bits;
- `brick_level0_noatomics`, `brick_level0_atomics_only`: this tree's B9
  with the atomics of its level 0 (dense, 8,000 float2 slots) sent to
  the sink, or those of every other level: what level 0 costs now.

Prints each library's ptxas registers and the SASS instruction counts of
the backward kernels, then, with the tolerances of `chip_smoke.py`:

- B11 and B12 at path D's 393,216 (x,t) points (five hashed levels,
  20,480 rows) and the 3D lattice's 393,216 points (eight levels, a dense
  level 0, 30,657 rows), ray order and randomly permuted: dL/dtable and
  dL/dx against the plain version, B12's dL/dx bitwise equal in two runs
  and between the orders, dL/dtable's distance to a float64 sum of the
  same contributions (the plain version's and three runs each of the
  parent's, the new and the one-atomic-a-lane kernels'), the float2
  atomics issued (`ops/permuto_cell.atomic_groups`), times in turns
  (parent, new, probes, probes reversed, new, parent); B10 and B13
  bitwise against the parent (their code did not change);
- B9 at the F=2 NeuS train step's 147,456 points × 4 levels (9,648 rows),
  ray order and permuted: dL/dg_up and dL/dx bitwise against the parent,
  dL/dtable against the plain version and a float64 sum, the atomics
  issued (`ops/lotd_brick.brick_atomic_groups`), times in turns;

The last line of its output is one JSON object with every number. It
exits 1 if a comparison failed (the JSON's "failed" names it).
"""

from __future__ import annotations

import ctypes
import json
import re
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
# the parent's B9: its atomic, and its loop over the levels
PARENT_B9_ATOMIC = \
    "      atomic_add2(dtab + base + off, make_float2(ck * g.x, ck * g.y));"
PARENT_B9_SINK = ("      if (ck == 1.0e38f && g.x == -1.0e38f) "
                  "atomic_add2(dtab + base + off, make_float2(ck, g.y));")
PARENT_B9_LOOP = """  const float ggp[3] = {gg[p * 3], gg[p * 3 + 1], gg[p * 3 + 2]};
  float d[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < L; ++l) {"""
# this tree's B9: its atomics, kept at one level only or at all but one
NEW_B9_ADD = ("      warp_add2(dtab, base + off, make_float2(ck * g.x, ck * g.y), "
              "active);")
# this tree's B9: the level sum of dL/dx
NEW_B9_FMA = """        d = fmaf(es[ll * BRICK_POINTS * 3 + k],
                 (float)(meta.lv[ll].res[a] - 2), d);"""
NEW_B9_UNFUSED = """        d = __fadd_rn(d, __fmul_rn(es[ll * BRICK_POINTS * 3 + k],
                                   (float)(meta.lv[ll].res[a] - 2)));"""
NEUS_F2_META = ([16, 32, 64, 128], ["Dense", "Dense", "Hash", "Hash"], 4096)


def _probe(name: str, src: str, header: bool, old: str, new: str) -> tuple:
    """A copy of this tree's `csrc/` in BUILD/name with `old` replaced by
    `new` in warp_atomics.cuh (header) or in `src`; (source, -I dir)."""
    out = BUILD / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(NEW, out)
    target = out / ("warp_atomics.cuh" if header else src)
    text = target.read_text()
    if old not in text:
        raise RuntimeError(f"{target.name}: the text {name} replaces is not "
                           f"in it")
    target.write_text(text.replace(old, new, 1))
    return out / src, out


def _parent_probe(name: str, parent: Path, src: str, old: str, new: str
                  ) -> tuple:
    out = BUILD / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(parent, out)
    text = (out / src).read_text()
    if old not in text:
        raise RuntimeError(f"{src}: the text {name} replaces is not in it")
    (out / src).write_text(text.replace(old, new, 1))
    return out / src, out


def _agg_body() -> str:
    text = (NEW / "warp_atomics.cuh").read_text()
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
            elif "registers" in line and "bwd" in entry:
                print(f"[ptxas {name}] {entry[:60]}: {line.strip()}")


def _sass_counts(lib: Path) -> dict:
    """Instructions (NOPs aside) of each backward kernel in the library's
    SASS."""
    from nr3d_lib_tpu_torch.ops import _build as B

    cuobjdump = Path(B._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "bwd" in m.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line) and \
                "NOP" not in line:
            counts[name] += 1
    return counts


def _build() -> dict:
    parent = Path(sys.argv[1]).resolve()
    BUILD.mkdir(parents=True, exist_ok=True)
    body = _agg_body()
    sources = {
        "pc_parent": (parent / "permuto_cell.cu", parent),
        "pc_new": (NEW / "permuto_cell.cu", NEW),
        "pc_noatomics": _probe("pc_noatomics", "permuto_cell.cu", True, body,
                               NO_ATOMICS),
        "pc_lane_atomics": _probe("pc_lane_atomics", "permuto_cell.cu", True,
                                  body, LANE_ATOMICS),
        "brick_parent": (parent / "brick.cu", parent),
        "brick_new": (NEW / "brick.cu", NEW),
        "brick_noatomics": _probe("brick_noatomics", "brick.cu", True, body,
                                  NO_ATOMICS),
        "brick_lane_atomics": _probe("brick_lane_atomics", "brick.cu", True,
                                     body, LANE_ATOMICS),
        "brick_parent_noatomics": _parent_probe(
            "brick_parent_noatomics", parent, "brick.cu", PARENT_B9_ATOMIC,
            PARENT_B9_SINK),
        "brick_parent_level0": _parent_probe(
            "brick_parent_level0", parent, "brick.cu", PARENT_B9_LOOP,
            PARENT_B9_LOOP.replace("l < L", "l < 1")),
        "brick_unfused": _probe("brick_unfused", "brick.cu", False,
                                NEW_B9_FMA, NEW_B9_UNFUSED),
        "brick_level0_noatomics": _probe(
            "brick_level0_noatomics", "brick.cu", False, NEW_B9_ADD,
            "      if (l != 0 || ck == 1.0e38f)\n  " + NEW_B9_ADD),
        "brick_level0_atomics_only": _probe(
            "brick_level0_atomics_only", "brick.cu", False, NEW_B9_ADD,
            "      if (l == 0 || ck == 1.0e38f)\n  " + NEW_B9_ADD),
    }
    _nvcc_all(sources)
    return {name: BUILD / f"lib{name}.so" for name in sources}


def _load(path: Path) -> ctypes.CDLL:
    from nr3d_lib_tpu_torch.ops import lotd_brick as B
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    vp, n = ctypes.c_void_p, ctypes.c_longlong
    lib = ctypes.CDLL(str(path))
    if hasattr(lib, "brick_bwd2"):
        sigs = {"brick_bwd2": [vp, vp, vp, vp, B._Meta, vp, vp, vp, n, vp]}
    else:
        sigs = {"permuto_fwd": [vp, vp, PC._Meta, vp, n, vp],
                "permuto_bwd": [vp, vp, vp, PC._Meta, vp, vp, n, vp],
                "permuto_dydx": [vp, vp, vp, PC._Meta, vp, n, vp]}
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


class _Cell:
    """The F=2 cell permuto kernels of one library, called as the
    wrappers call them."""

    def __init__(self, lib, dev):
        self.lib, self.dev = lib, dev

    def fwd(self, x, table, meta):
        import torch
        from nr3d_lib_tpu_torch.ops import _build as B
        from nr3d_lib_tpu_torch.ops import permuto_cell as PC

        y = torch.empty(x.shape[0], 2 * meta.n_levels, device=self.dev)
        B.check(self.lib.permuto_fwd(
            x.data_ptr(), table.data_ptr(), PC.c_meta(meta), y.data_ptr(),
            x.shape[0], B.stream_ptr(self.dev)), "fwd")
        return y

    def bwd(self, x, g, table, meta, need_dx):
        import torch
        from nr3d_lib_tpu_torch.ops import _build as B
        from nr3d_lib_tpu_torch.ops import permuto_cell as PC

        dtab = torch.empty(meta.total_rows, 128, device=self.dev)
        dx = torch.empty_like(x) if need_dx else None
        B.check(self.lib.permuto_bwd(
            x.data_ptr(), g.data_ptr(), table.data_ptr() if need_dx else None,
            PC.c_meta(meta), dtab.data_ptr(),
            dx.data_ptr() if need_dx else None, x.shape[0],
            B.stream_ptr(self.dev)), "bwd")
        return dx, dtab

    def dydx(self, g, x, table, meta):
        import torch
        from nr3d_lib_tpu_torch.ops import _build as B
        from nr3d_lib_tpu_torch.ops import permuto_cell as PC

        dx = torch.empty_like(x)
        B.check(self.lib.permuto_dydx(
            g.data_ptr(), x.data_ptr(), table.data_ptr(), PC.c_meta(meta),
            dx.data_ptr(), x.shape[0], B.stream_ptr(self.dev)), "dydx")
        return dx


def _bwd2(lib, dev, g, x, table, gg, meta, need_dx):
    """B9 of one library → (dL/dg_up, dL/dx or None, dL/dtable)."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    dg = torch.empty_like(g)
    dtab = torch.empty(meta.total_rows, 128, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    Bu.check(lib.brick_bwd2(g.data_ptr(), x.data_ptr(), table.data_ptr(),
                            gg.data_ptr(), B.c_meta(meta), dg.data_ptr(),
                            dtab.data_ptr(),
                            dx.data_ptr() if need_dx else None, x.shape[0],
                            Bu.stream_ptr(dev)), "brick_bwd2")
    return dg, dx, dtab


def _rays_ts(dev):
    import torch
    import chip_smoke as CS

    o, d = (torch.from_numpy(a).to(dev) for a in CS._rays(CS.N_RAYS, seed=0))
    ts = torch.from_numpy(np.random.default_rng(6).uniform(
        -1.0, 1.0, CS.N_RAYS).astype(np.float32)).to(dev)
    return o, d, ts


def _inputs(dev, rows: int, width: int, n: int, n_out: int, seed: int):
    import torch

    table = torch.from_numpy(np.random.default_rng(seed).uniform(
        -0.1, 0.1, (rows, width)).astype(np.float32)).to(dev)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    g = torch.randn(n, n_out, device=dev, generator=gen)
    gd = torch.randn(n, 3, device=dev, generator=gen)
    perm = torch.randperm(n, device=dev,
                          generator=torch.Generator(dev).manual_seed(5))
    return table, g, gd, perm


def _f64_dist(dtabs, ref) -> list:
    return [float((t.double().view(ref.shape) - ref).abs().max())
            for t in dtabs]


def _permuto(libs: dict, dev) -> dict:
    """B11/B12 (and B10, B13 bitwise) at path D and the 3D lattice."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    o, d, ts = _rays_ts(dev)
    k = {n: _Cell(libs[n], dev) for n in libs}
    res = {}
    names = ("pc_parent", "pc_new", "pc_noatomics", "pc_lane_atomics")
    for what, meta, x in (
            ("pathd", PC.make_permuto_cell_meta(
                4, [8.0, 16.0, 32.0, 64.0, 128.0], 4096),
             CS._dyn_points(o, d, ts, 96, seed=26)),
            ("3d", PC.make_permuto_cell_meta(
                3, [16.0 * 2 ** (0.5 * i) for i in range(8)], 4096),
             CS._ray_points(o, d, 96, seed=27))):
        n, L = x.shape[0], meta.n_levels
        table, g, _, perm = _inputs(dev, meta.total_rows, 128, n, 2 * L, 7)
        res[f"{what}_n"] = n
        res[f"{what}_atomics_naive"] = n * L * (meta.n_dims + 1)
        with torch.no_grad():
            res[f"b10_{what}_bitwise_vs_parent"] = bool(torch.equal(
                k["pc_new"].fwd(x, table, meta),
                k["pc_parent"].fwd(x, table, meta)))
            res[f"b13_{what}_bitwise_vs_parent"] = bool(torch.equal(
                k["pc_new"].dydx(g, x, table, meta),
                k["pc_parent"].dydx(g, x, table, meta)))
            # dL/dtable in float64 from the same float32 weights: how far
            # each float32 sum (the plain version's, the kernels') lies
            # from the exact one
            ref = torch.zeros(meta.total_rows * 64, 2, dtype=torch.float64,
                              device=dev)
            for l, lv in enumerate(meta.levels):
                vtx, bary, _ = PC._level_vertices(x, lv, meta)
                ref.index_add_(0, vtx.reshape(-1), (
                    bary[..., None].double() *
                    g[:, None, 2 * l:2 * l + 2].double()).reshape(-1, 2))
            _, dtab_p = PC.permuto_cell_encode_bwd_xla(x, table, g, meta,
                                                       False)
            res[f"b11_{what}_dtab_vs_f64"] = {"plain": _f64_dist([dtab_p],
                                                                 ref)[0]}
            for m in ("pc_parent", "pc_new", "pc_lane_atomics"):
                res[f"b11_{what}_dtab_vs_f64"][m] = _f64_dist(
                    [k[m].bwd(x, g, table, meta, False)[1] for _ in range(3)],
                    ref)
            del ref
            dxs = {}
            for order, xx, gg in (("ray", x, g),
                                  ("permuted", x[perm].contiguous(),
                                   g[perm].contiguous())):
                groups = PC.atomic_groups(xx, meta)
                res[f"{what}_{order}_atomic_groups"] = sum(groups)
                res[f"{what}_{order}_atomic_groups_by_level"] = groups
                dx_p, dtab_p = PC.permuto_cell_encode_bwd_xla(
                    xx, table, gg, meta, True)
                for need_dx, tag in ((False, "b11"), (True, "b12")):
                    key = f"{tag}_{what}_{order}"
                    dx, dtab = k["pc_new"].bwd(xx, gg, table, meta, need_dx)
                    res[f"{key}_dtab_err"] = float(
                        (dtab - dtab_p).abs().max())
                    res[f"{key}_dtab_tol"] = 1e-6 + 1e-5 * float(
                        dtab_p.abs().max())
                    res[f"{key}_lane_atomics_dtab_err"] = float((k[
                        "pc_lane_atomics"].bwd(xx, gg, table, meta, need_dx)
                        [1] - dtab_p).abs().max())
                    if need_dx:
                        res[f"{key}_dx_err"] = float((dx - dx_p).abs().max())
                        res[f"{key}_dx_tol"] = 1e-4 + 1e-4 * float(
                            dx_p.abs().max())
                        res[f"{key}_dx_bitwise_between_runs"] = bool(
                            torch.equal(dx, k["pc_new"].bwd(
                                xx, gg, table, meta, True)[0]))
                        dxs[order] = dx
                    res[f"{key}_ms"] = _turns(
                        {m: (lambda m=m, xx=xx, gg=gg, nd=need_dx:
                             k[m].bwd(xx, gg, table, meta, nd))
                         for m in names}, names + names[::-1])
            res[f"b12_{what}_dx_bitwise_between_orders"] = bool(torch.equal(
                dxs["permuted"], dxs["ray"][perm]))
    return res


def _brick(libs: dict, dev) -> dict:
    """B9 at the F=2 NeuS train step's shape."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    o, d, _ = _rays_ts(dev)
    meta = B.make_brick_meta(*NEUS_F2_META)
    x = CS._ray_points(o, d, 36, seed=14)
    n, L = x.shape[0], meta.n_levels
    table, g, gg, perm = _inputs(dev, meta.total_rows, 128, n, 2 * L, 15)
    res = {"n": n, "rows": meta.total_rows, "atomics_naive": n * L * 8}

    def run(m, g_, x_, gg_, need_dx=True):
        return _bwd2(libs[m], dev, g_, x_, table, gg_, meta, need_dx)

    with torch.no_grad():
        # dL/dtable in float64 from the same float32 cell fractions
        ref = torch.zeros(meta.total_rows * 64, 2, dtype=torch.float64,
                          device=dev)
        bits = B._corner_bits(dev)
        offs = (bits[:, 0] * 4 + bits[:, 1]) * 4 + bits[:, 2]
        sg = 2.0 * bits.double() - 1.0                                 # [8,3]
        for l, lv in enumerate(meta.levels):
            row, lane0, frac = B._level_rows_and_lanes(x, lv)
            f = frac.double()[:, None, :]
            s = f * bits + (1.0 - f) * (1.0 - bits)                    # [N,8,3]
            dd = gg.double() * torch.tensor([float(r - 2) for r in lv.res],
                                            dtype=torch.float64, device=dev)
            ck = sum(dd[:, None, a] * sg[None, :, a] *
                     s[..., [b for b in range(3) if b != a]].prod(-1)
                     for a in range(3))                                # [N,8]
            slot = row[:, None] * 64 + lane0[:, None] // 2 + offs
            ref.index_add_(0, slot.reshape(-1), (
                ck[..., None] * g[:, None, 2 * l:2 * l + 2].double())
                .reshape(-1, 2))
        _, _, dt_p = B.brick_nablas_bwd_xla(g, x, table, gg, meta)
        res["dtab_vs_f64"] = {"plain": _f64_dist([dt_p], ref)[0]}
        for m in ("brick_parent", "brick_new", "brick_lane_atomics"):
            res["dtab_vs_f64"][m] = _f64_dist(
                [run(m, g, x, gg, False)[2] for _ in range(3)], ref)
        del ref
        names = ("brick_parent", "brick_new", "brick_noatomics",
                 "brick_lane_atomics", "brick_parent_noatomics",
                 "brick_parent_level0", "brick_level0_noatomics",
                 "brick_level0_atomics_only")
        outs = {}
        for order, xx, g2, gg2 in (
                ("ray", x, g, gg),
                ("permuted", *(v[perm].contiguous() for v in (x, g, gg)))):
            groups = B.brick_atomic_groups(xx, meta)
            res[f"{order}_atomic_groups"] = sum(groups)
            res[f"{order}_atomic_groups_by_level"] = groups
            dg_p, dx_p, dt_p = B.brick_nablas_bwd_xla(g2, xx, table, gg2,
                                                      meta)
            new = run("brick_new", g2, xx, gg2)
            par = run("brick_parent", g2, xx, gg2)
            unf = run("brick_unfused", g2, xx, gg2)
            outs[order] = new
            res[f"b9_{order}_dgup_bitwise_vs_parent"] = bool(
                torch.equal(new[0], par[0]))
            res[f"b9_{order}_dx_bitwise_vs_parent"] = bool(
                torch.equal(new[1], par[1]))
            res[f"b9_{order}_unfused_dx_equal_parent"] = bool(
                torch.equal(unf[1], par[1]))
            res[f"b9_{order}_dx_max_diff_vs_parent"] = float(
                (new[1] - par[1]).abs().max())
            res[f"b9_{order}_dgup_err"] = float((new[0] - dg_p).abs().max())
            res[f"b9_{order}_dgup_tol"] = 1e-4 + 1e-4 * float(
                dg_p.abs().max())
            res[f"b9_{order}_dx_err"] = float((new[1] - dx_p).abs().max())
            res[f"b9_{order}_dx_tol"] = 1e-4 + 1e-4 * float(dx_p.abs().max())
            res[f"b9_{order}_dtab_err"] = float((new[2] - dt_p).abs().max())
            res[f"b9_{order}_dtab_tol"] = 1e-6 + 1e-5 * float(
                dt_p.abs().max())
            res[f"b9_{order}_lane_atomics_dtab_err"] = float(
                (run("brick_lane_atomics", g2, xx, gg2)[2] - dt_p)
                .abs().max())
            res[f"b9_{order}_ms"] = _turns(
                {m: (lambda m=m, a=(g2, xx, gg2): run(m, *a, False))
                 for m in names}, names + names[::-1])
            two = ("brick_parent", "brick_new")
            res[f"b9_dx_{order}_ms"] = _turns(
                {m: (lambda m=m, a=(g2, xx, gg2): run(m, *a, True))
                 for m in two}, two + two[::-1])
        inv = torch.argsort(perm)
        res["b9_bitwise_between_orders"] = bool(
            torch.equal(outs["permuted"][0][inv], outs["ray"][0]) and
            torch.equal(outs["permuted"][1][inv], outs["ray"][1]))
    return res


def _check(res: dict) -> list:
    """What the run must show; the names of what failed."""
    bad = []
    for part in ("permuto", "brick"):
        for key, v in res[part].items():
            tol = res[part].get(key[:-4] + "_tol")
            if key.endswith("_err") and tol is not None and v > tol:
                bad.append(f"{part}.{key}")
            if "bitwise" in key and v is not True:
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

    dev = torch.device("cuda")
    smi = CS._smi()
    print(f"[device] {smi}")
    t0 = time.perf_counter()
    paths = _build()
    print(f"[build] {len(paths)} libraries: {time.perf_counter() - t0:.1f} s")
    res = {"device": smi, "sass": {
        name: _sass_counts(paths[name])
        for name in ("pc_parent", "pc_new", "brick_parent", "brick_new")}}
    print(f"[sass] {json.dumps(res['sass'])}")
    libs = {n: _load(p) for n, p in paths.items()}
    res["permuto"] = _permuto({n: l for n, l in libs.items()
                               if n.startswith("pc_")}, dev)
    print(f"[B11/B12] {json.dumps(res['permuto'])}")
    res["brick"] = _brick({n: l for n, l in libs.items()
                           if n.startswith("brick")}, dev)
    print(f"[B9] {json.dumps(res['brick'])}")
    res["failed"] = _check(res)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
