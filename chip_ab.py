#!/usr/bin/env python3
"""Time the parent commit's B18 and B10 kernels against this tree's, in
turns, on one card, and compare their outputs.

    git archive <parent> nr3d_lib_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_ab.py _archive/parent/nr3d_lib_tpu_torch/csrc

(`_archive/` is listed in `.gitignore`; run the second line where the
card is.) Builds, with the port's nvcc flags, into `_archive/ab_build/`:
the parent's `gaussian_blend.cu` and `permuto_cell.cu` (each with its own
`permuto_simplex.cuh`), this tree's, and three probes made from this
tree's sources by text substitution — B18 without its warp sums
(`gb_nosums`: wrong gradients, the sums' cost), B18 with a butterfly
reduce-scatter in place of its ten warp sums (`gb_butterfly`) and B10
without its table loads (`pc_noloads`: wrong outputs, the loads' cost).
Prints each library's ptxas registers, then:

- B18 at the bench scene's per-tile attrs (`chip_smoke._gs_params`,
  500,000 gaussians, 512², tile 16, capacity 256) with upstream gradients
  from numpy: the pairs above the α floor, the (warp, slot) pairs that
  take a slot, each build's largest row-relative difference to
  `gs_blend_bwd_plain` and whether it equals the parent's bitwise, and
  device times in turns (parent, new, probes, probes reversed, new,
  parent) by `chip_smoke._time_ms`;
- B10 at path D's 393,216 (x,t) points and at the 3D lattice's 393,216
  points (`chip_smoke._dyn_points`, `_ray_points`), each in ray order and
  randomly permuted: bitwise equality with the parent and times in turns
  (parent, new, probe, probe, new, parent).

The last line of its output is one JSON object with every number.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BUILD = REPO / "_archive" / "ab_build"
NEW = REPO / "nr3d_lib_tpu_torch" / "csrc"

WARP_SUM = "          const float w = warp_sum(on ? v[r] : 0.0f);"
SUMS = """#pragma unroll
        for (int r = 0; r < N_GRAD; ++r) {
          const float w = warp_sum(on ? v[r] : 0.0f);
          if (lane == 0) red[(warp * N_GRAD + r) * CHUNK_B + j] = w;
        }"""
# value r at index r (r < 5) or r + 3 of 16; after four halving exchanges
# and a last one, lane l holds the warp's sum of index l >> 1
BUTTERFLY = """        float u[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) u[q] = 0.0f;
#pragma unroll
        for (int r = 0; r < N_GRAD; ++r)
          u[r < 5 ? r : r + 3] = on ? v[r] : 0.0f;
#pragma unroll
        for (int half = 8, off = 16; off >= 2; half >>= 1, off >>= 1) {
          const bool up = (lane & off) != 0;
#pragma unroll
          for (int q = 0; q < half; ++q) {
            if (off == 16 && q >= 5) continue;
            const float send = up ? u[q] : u[q + half];
            const float keep = up ? u[q + half] : u[q];
            u[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
        }
        u[0] += __shfl_xor_sync(0xffffffffu, u[0], 1);
        {
          const int q = lane >> 1;
          const int r = q < 5 ? q : (q >= 8 && q < 13 ? q - 3 : -1);
          if ((lane & 1) == 0 && r >= 0)
            red[(warp * N_GRAD + r) * CHUNK_B + j] = u[0];
        }"""
LOAD = "      const float2 v = __ldg(table + s.vtx[k]);"
NO_LOAD = "      const float2 v = make_float2((float)s.vtx[k], 1.f);"


def _substituted(src: Path, old: str, new: str, name: str) -> Path:
    text = src.read_text()
    if old not in text:
        raise RuntimeError(f"{src.name}: the text {name} replaces is not "
                           f"in it")
    out = BUILD / f"{name}.cu"
    out.write_text(text.replace(old, new, 1))     # the first: the forward's
    return out


def _build(parent: Path) -> dict:
    """name -> (loaded library, chunk of B18's checkpoint scratch)."""
    from nr3d_lib_tpu_torch.ops import _build as B
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    BUILD.mkdir(parents=True, exist_ok=True)
    gb, pc = NEW / "gaussian_blend.cu", NEW / "permuto_cell.cu"
    sources = {
        "gb_parent": (parent / "gaussian_blend.cu", 32),
        "gb_new": (gb, 16),
        "gb_nosums": (_substituted(
            gb, WARP_SUM, "          const float w = on ? v[r] : 0.0f;",
            "gb_nosums"), 16),
        "gb_butterfly": (_substituted(gb, SUMS, BUTTERFLY, "gb_butterfly"),
                         16),
        "pc_parent": (parent / "permuto_cell.cu", None),
        "pc_new": (pc, None),
        "pc_noloads": (_substituted(pc, LOAD, NO_LOAD, "pc_noloads"), None),
    }
    procs = {}
    for name, (src, _) in sources.items():
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-I", str(src.parent), "-I",
               str(NEW), "-o", str(BUILD / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        for line in text.splitlines():
            if "Compiling entry" in line or "registers" in line:
                print(f"[ptxas {name}] {line.strip()}")
        lib = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
        if name.startswith("gb"):
            lib.gs_blend_bwd.argtypes = [vp] * 7 + [ci, ci, ci, cf, cf, cf,
                                                    cf, vp]
            lib.gs_blend_bwd.restype = ci
        else:
            lib.permuto_fwd.argtypes = [vp, vp, PC._Meta, vp, cl, vp]
            lib.permuto_fwd.restype = ci
        libs[name] = (lib, sources[name][1])
    return libs


def _turns(fns: dict, order) -> dict:
    import chip_smoke as CS

    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(CS._time_ms(fns[k]))
    return ms


def _b18(libs: dict, dev) -> dict:
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch import bridge
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS
    from nr3d_lib_tpu_torch.ops import _build as B

    p = bridge.gaussians_from_jax(CS._gs_params(CS.GS_N, seed=21),
                                  device=dev)
    with torch.no_grad():
        attrs, origin, _, _ = GS._tile_attrs(
            p["means"], p["scales"], p["quats"], p["opac"], p["cols"],
            *CS._gs_camera(dev), CS.GS_HW, **CS.GS_CFG)
    tile = CS.GS_CFG["tile"]
    n_t, _, k = attrs.shape
    n_px = tile * tile
    rng = np.random.default_rng(31)
    g = tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
              for s in ((n_t, n_px, 3), (n_t, n_px), (n_t, n_px)))
    bg, floor = (0.0, 0.0, 0.0), 1.0 / 255.0
    above = GS._alpha_parts(attrs, origin, tile, floor)[5]     # [T, P, K]
    res = {"pairs_above_floor": int(above.sum()),
           "warp_slot_pairs": n_t * (n_px // 32) * k,
           "warp_slot_hits": int(above.view(n_t, n_px // 32, 32, k)
                                 .any(2).sum())}
    del above

    def run(name):
        lib, chunk = libs[name]
        threads = -(-n_px // 32) * 32
        ckpt = torch.empty(n_t * -(-k // chunk) * threads, device=dev)
        d = torch.empty_like(attrs)
        B.check(lib.gs_blend_bwd(
            attrs.data_ptr(), origin.data_ptr(), g[0].data_ptr(),
            g[1].data_ptr(), g[2].data_ptr(), d.data_ptr(), ckpt.data_ptr(),
            n_t, k, tile, *bg, floor, B.stream_ptr(dev)), name)
        return d

    want = GS.gs_blend_bwd_plain(attrs, origin, *g, bg, tile, floor)
    parent = run("gb_parent")
    for name in ("gb_new", "gb_butterfly"):
        d = run(name)
        res[f"{name}_rel_vs_plain"] = max(
            float((d[:, r] - want[:, r]).abs().max() /
                  want[:, r].abs().max()) for r in range(10))
        res[f"{name}_bitwise_vs_parent"] = bool(torch.equal(d, parent))
        res[f"{name}_max_abs_vs_parent"] = float((d - parent).abs().max())
    names = ("gb_parent", "gb_new", "gb_butterfly", "gb_nosums")
    res["ms"] = _turns({n: (lambda n=n: run(n)) for n in names},
                       names + names[::-1])
    return res


def _b10(libs: dict, dev) -> dict:
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.models.fields.sdf import PermutoSDF
    from nr3d_lib_tpu_torch.models.model_families import \
        DynamicPermutoNeuSModel
    from nr3d_lib_tpu_torch.ops import _build as B
    from nr3d_lib_tpu_torch.ops import permuto_cell as PC

    pathd = DynamicPermutoNeuSModel(**CS.PATHD_CFG, seed=0)
    sdf = PermutoSDF(permuto_cfg=CS.FIELD_PERMUTO, seed=0, device=dev)
    o, d = (torch.from_numpy(a).to(dev) for a in CS._rays(CS.N_RAYS, seed=0))
    ts = torch.from_numpy(np.random.default_rng(6).uniform(
        -1.0, 1.0, CS.N_RAYS).astype(np.float32)).to(dev)
    res = {}
    for what, meta, x in (
            ("pathd", pathd.field.implicit_surface.bank.meta,
             CS._dyn_points(o, d, ts, 96, seed=26)),
            ("3d", sdf.bank.meta, CS._ray_points(o, d, 96, seed=27))):
        table = torch.from_numpy(np.random.default_rng(7).uniform(
            -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(dev)
        perm = torch.randperm(x.shape[0], device=dev,
                              generator=torch.Generator(dev).manual_seed(5))
        for order, xx in (("ray", x), ("permuted", x[perm].contiguous())):
            def run(name, xx=xx):
                y = torch.empty(xx.shape[0], meta.out_features, device=dev)
                B.check(libs[name][0].permuto_fwd(
                    xx.data_ptr(), table.data_ptr(), PC.c_meta(meta),
                    y.data_ptr(), xx.shape[0], B.stream_ptr(dev)), name)
                return y

            res[f"{what}_{order}_bitwise_vs_parent"] = bool(torch.equal(
                run("pc_new"), run("pc_parent")))
            names = ("pc_parent", "pc_new", "pc_noloads")
            res[f"{what}_{order}_ms"] = _turns(
                {n: (lambda n=n: run(n)) for n in names}, names + names[::-1])
    return res


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not Path(sys.argv[1], "gaussian_blend.cu") \
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
    libs = _build(Path(sys.argv[1]).resolve())
    print(f"[build] {len(libs)} libraries: {time.perf_counter() - t0:.1f} s")
    res = {"device": smi, "b18": _b18(libs, dev)}
    print(f"[B18] {json.dumps(res['b18'])}")
    res["b10"] = _b10(libs, dev)
    print(f"[B10] {json.dumps(res['b10'])}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
