#!/usr/bin/env python3
"""Time the parent commit's B6 kernel against this tree's, in turns, on one
card, with probes, and compare their outputs: the F=2 brick encode B6
(`brick_fwd`, `csrc/brick.cu`) in both of its forms, y only and want_g (y
and the corner values that B7 reads back).

    git archive <parent> nr3d_lib_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_ab.py _archive/parent/nr3d_lib_tpu_torch/csrc

(`_archive/` is listed in `.gitignore`; run the second line where the
card is.) Builds, with the port's nvcc flags, into `_archive/ab_build/`,
one nvcc per library, all started together, each source with its own
directory's headers (`-I`): the parent's and this tree's `brick.cu`, and
probes made by text substitution of this tree's, in lieu of `ncu`:

- `brick_lane_corners`: the want_g corners written by each lane as its
  own 64 bytes, four float4 stores, not staged in shared memory (the
  other layout; y and the corners stay right);
- `brick_stage_x`: the block's x staged in shared memory behind a
  barrier, as B7 and B9 stage it, not read by each lane (right);
- `brick_direct_y`: y stored by each lane, L·8 bytes from its
  neighbour's, not through shared memory (right);
- `brick_pair_loads`: each pair of corners adjacent in z read by one
  16-byte load where the pair is 16-byte aligned (even vertex), else by
  two (right);
- `brick_noloads`: no table loads (each corner's value is made from its
  row and vertex: wrong outputs, the loads' cost);
- `brick_nostores`: y and the corners not stored to device memory (each
  store behind a test that fails: the stores' cost);
- `brick_noloads_nostores`: both (what is left: the index math, the
  weights, x's loads and the shared-memory staging);
- `brick_nomod`: the hash level's `h % n_rows` as `h & (n_rows - 1)`
  (the modulo's cost; exact where n_rows is a power of two, as at every
  hashed level of the two F=2 configurations).

Prints each library's ptxas registers of B6's two instances, the SASS
instruction counts of B6 and of B7, B8 and B9 (whose source did not
change: their instructions, parent and new, must be the same lists), then:

- B6 at the three shapes of its `PERF.md` rows, from `chip_smoke.py`'s
  seeded models and points: the NeRF render's 196,608 points × 6 levels
  (23,005 rows), the NeuS render's 589,824 × 4 (9,648 rows) and the
  want_g form at the NeuS train step's 147,456 × 4; each in ray order and
  randomly permuted. y bitwise the parent's in both forms and equal in
  the two forms, the corners equal to the parent's and to the plain
  version's, a permuted batch's y the permuted y, y within 1e-5 of the
  plain version; times in turns (parent, new, probes, probes reversed,
  new, parent), y only and want_g, and each row's bound;
- B6 on the inputs of each of its six launches in one F=2 NeuS render
  (recorded around `lotd_brick._fwd_cuda`): y bitwise the parent's,
  times in turns, each launch's bound;
- B6 inside the paths, with `lotd_brick._fwd_cuda` routed to the
  parent's or the new library, in turns (torch.profiler; ms per pass
  over three passes): the F=2 NeuS render (6 launches), that model's
  autograd nablas (`forward_sdf` with x requiring grad: 1 want_g launch
  and B7) on the train step's 147,456 points, and its train step at it =
  23 (forward and backward, no optimizer step; `chip_smoke.py`'s seeded
  model after 22 of its train steps); B6's device time and the pass's
  device time in each, and the pass's outputs bitwise equal between the
  two libraries.

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

REPO = Path(__file__).resolve().parent
BUILD = REPO / "_archive" / "ab_build"
NEW = REPO / "nr3d_lib_tpu_torch" / "csrc"

# this tree's B6: a lane's corners into shared memory, the block's run out
# of it, and the run's shared memory at the launch
STAGE_CORNERS = """        cs[i * rec + l * 4 + q] = make_float4("""
LANE_CORNERS = (
    """        corners[((p0 + i) * L + l) * 4 + q] = make_float4(""")
STAGE_OUT = "      if (pi < np) out[j * 32 * L + t] = cs[pi * rec + tr];"
LANE_OUT = "      (void)out;"
STAGE_SMEM = ("      const size_t smem = (size_t)BRICK_POINTS * (4 * L + 1) * "
              "sizeof(float4);")
LANE_SMEM = "      const size_t smem = 0;"
LOAD = "      v[k] = __ldg(rowp + corner_off(k));"
NO_LOAD = ("      v[k] = make_float2((float)(c.row * 64 + c.vert0 + "
           "corner_off(k)), (float)c.vert0);")
Y_OUT = "  if (t < np * L) y[p0 * L + t] = ys[t];  // np L <= 32 L = blockDim"
Y_SINK = "  if (t < np * L && ys[t].x == 1.0e38f) y[p0 * L + t] = ys[t];"
C_SINK = ("      if (pi < np && cs[pi * rec + tr].x == 1.0e38f)\n"
          "        out[j * 32 * L + t] = cs[pi * rec + tr];")
Y_STAGE = "    ys[i * L + l] = make_float2(a0, a1);"
Y_DIRECT = "    y[(p0 + i) * L + l] = make_float2(a0, a1);"
X_DIRECT = """  const int rec = 4 * L + 1;  // float4s a point takes in cs
  if (i < np) {
    const float* xi = x + (p0 + i) * 3;
    const float xp[3] = {xi[0], xi[1], xi[2]};"""
X_STAGE = """  __shared__ float xs[BRICK_POINTS * 3];
  for (int k = t; k < np * 3; k += blockDim.x) xs[k] = x[p0 * 3 + k];
  __syncthreads();
  const int rec = 4 * L + 1;  // float4s a point takes in cs
  if (i < np) {
    const float xp[3] = {xs[i * 3], xs[i * 3 + 1], xs[i * 3 + 2]};"""
MOD = "    row = (int)(h % (uint32_t)L.n_rows);"
NO_MOD = "    row = (int)(h & (uint32_t)(L.n_rows - 1));"
LOOP = """    float2 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {"""
PAIRS = """    float2 v[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2* pp = rowp + corner_off(2 * q);
      if (c.vert0 & 1) {
        v[2 * q] = __ldg(pp);
        v[2 * q + 1] = __ldg(pp + 1);
      } else {
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(pp));
        v[2 * q] = make_float2(w4.x, w4.y);
        v[2 * q + 1] = make_float2(w4.z, w4.w);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {"""
PROBES = {
    "brick_lane_corners": [(STAGE_CORNERS, LANE_CORNERS),
                           (STAGE_OUT, LANE_OUT), (STAGE_SMEM, LANE_SMEM)],
    "brick_stage_x": [(X_DIRECT, X_STAGE)],
    "brick_direct_y": [(Y_STAGE, Y_DIRECT), (Y_OUT, "")],
    "brick_pair_loads": [(LOOP, PAIRS), (LOAD, "")],
    "brick_noloads": [(LOAD, NO_LOAD)],
    "brick_nostores": [(Y_OUT, Y_SINK), (STAGE_OUT, C_SINK)],
    "brick_noloads_nostores": [(LOAD, NO_LOAD), (Y_OUT, Y_SINK),
                               (STAGE_OUT, C_SINK)],
    "brick_nomod": [(MOD, NO_MOD)],
}
NAMES = ("brick_parent", "brick_new", *PROBES)
TWO = ("brick_parent", "brick_new")
# the probes whose outputs are right
EXACT = ("brick_new", "brick_lane_corners", "brick_stage_x",
         "brick_direct_y", "brick_pair_loads")
B6 = "brick_fwd_kernel"
UNCHANGED = ("brick_bwd_kernel", "brick_dydx_kernel", "brick_bwd2_kernel")


def _probe(name: str, subs) -> tuple:
    """A copy of this tree's sources in BUILD/name with each (old, new) of
    `subs` replaced in `brick.cu`; (the copy's brick.cu, its -I dir)."""
    out = BUILD / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(NEW, out)
    text = (out / "brick.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"brick.cu: the text {name} replaces is not "
                               f"in it: {old!r}")
        text = text.replace(old, new, 1)
    (out / "brick.cu").write_text(text)
    return out / "brick.cu", out


def _nvcc_all(sources: dict) -> None:
    """One nvcc per library, all started together; prints ptxas'
    registers of B6's instances."""
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
            elif "registers" in line and B6 in entry:
                print(f"[ptxas {name}] {entry[:48]}: {line.strip()}")


def _build() -> dict:
    parent = Path(sys.argv[1]).resolve()
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = {"brick_parent": (parent / "brick.cu", parent),
               "brick_new": (NEW / "brick.cu", NEW)}
    sources.update({name: _probe(name, subs)
                    for name, subs in PROBES.items()})
    _nvcc_all(sources)
    return {name: BUILD / f"lib{name}.so" for name in sources}


def _load(path: Path) -> ctypes.CDLL:
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    vp, n = ctypes.c_void_p, ctypes.c_longlong
    lib = ctypes.CDLL(str(path))
    lib.brick_fwd.argtypes = [vp, vp, B._Meta, vp, vp, n, vp]
    lib.brick_fwd.restype = ctypes.c_int
    return lib


def _fwd(lib, x, table, meta, want_g=False):
    """B6 of one library → y [N,2L], or (y, corners [N,L,8,2])."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    n, L = x.shape[0], meta.n_levels
    y = torch.empty(n, 2 * L, device=x.device)
    c = torch.empty(n, L, 8, 2, device=x.device) if want_g else None
    Bu.check(lib.brick_fwd(x.data_ptr(), table.data_ptr(), B.c_meta(meta),
                           y.data_ptr(), B.ptr(c), n,
                           Bu.stream_ptr(x.device)), "brick_fwd")
    return (y, c) if want_g else y


def _turns(fns: dict, order) -> dict:
    import chip_smoke as CS

    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(CS._time_ms(fns[k]))
    return ms


def _models(dev):
    """`chip_smoke.py`'s path A and path B models, seeded as it seeds
    them."""
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.models.model_base import (LoTDNeRFModel,
                                                      LoTDNeuSModel)

    neus = LoTDNeuSModel(**CS.NEUS_F2_CFG, seed=0)
    CS._seed_weights(neus, neus.field.implicit_surface.encoding, 3)
    neus.populate()
    CS._seed_occupancy(neus)
    nerf = LoTDNeRFModel(**CS.NERF_CFG, seed=0)
    CS._seed_weights(nerf, nerf.field.encoding, 2)
    nerf.populate()
    CS._seed_occupancy(nerf)
    return neus, nerf


def _rays(dev, n):
    import torch
    import chip_smoke as CS

    return tuple(torch.from_numpy(a).to(dev) for a in CS._rays(n, seed=0))


def _same(res: dict, key: str, a, b) -> None:
    import torch

    res[key] = bool(torch.equal(a, b))


def _shape(libs: dict, x, table, meta, want_g: bool) -> dict:
    """B6 on the points x, in ray order and permuted: bits and times in
    turns."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    dev, (n, L) = x.device, (x.shape[0], meta.n_levels)
    perm = torch.randperm(n, device=dev,
                          generator=torch.Generator(dev).manual_seed(5))
    r = {"n": n, "levels": L, "rows": meta.total_rows}
    y_plain = B.brick_encode_xla(x, table, meta)
    for order, xx in (("ray", x), ("permuted", x[perm].contiguous())):
        out = {m: _fwd(libs[m], xx, table, meta, True)
               for m in ("brick_parent", *EXACT)}
        y_only = {m: _fwd(libs[m], xx, table, meta) for m in out}
        par_y, par_c = out["brick_parent"]
        for m in EXACT:
            y, c = out[m]
            _same(r, f"{order}_{m}_y_bitwise_vs_parent", y_only[m],
                  y_only["brick_parent"])
            _same(r, f"{order}_{m}_want_g_y_bitwise_vs_parent", y, par_y)
            _same(r, f"{order}_{m}_y_same_in_both_forms", y, y_only[m])
            _same(r, f"{order}_{m}_corners_equal_parent", c, par_c)
        if order == "ray":
            ray_y = y_only["brick_new"]
            r["y_err"] = float((ray_y - y_plain).abs().max())
            r["y_tol"] = 1e-5 + 1e-5 * float(y_plain.abs().max())
            if want_g:
                _same(r, "corners_equal_plain", out["brick_new"][1],
                      B.brick_corner_values_xla(x, table, meta))
        else:
            _same(r, "permuted_y_is_the_permuted_y", y_only["brick_new"],
                  ray_y[perm])
        r[f"{order}_ms"] = _turns(
            {m: (lambda m=m, a=xx: _fwd(libs[m], a, table, meta, want_g))
             for m in NAMES}, NAMES + NAMES[::-1])
    if not want_g:
        r["want_g_ms"] = _turns(
            {m: (lambda m=m: _fwd(libs[m], x, table, meta, True))
             for m in TWO}, TWO + TWO[::-1])
    r["bound_ms"], r["bound_by"] = CS._b6_bound(n, L, table.numel(),
                                                 want_g)
    return r


def _shapes(libs: dict, dev, neus, nerf) -> dict:
    """B6 at its rows' shapes, from `chip_smoke.py`'s points."""
    import torch
    import chip_smoke as CS

    o, d = _rays(dev, CS.N_RAYS)
    o8, d8 = _rays(dev, CS.N_RAYS_NERF)
    res = {}
    with torch.no_grad():
        for key, enc, x, want_g in (
                ("nerf", nerf.field.encoding,
                 CS._ray_points(o8, d8, 24, 12), False),
                ("neus", neus.field.implicit_surface.encoding,
                 CS._ray_points(o, d, 144, 13), False),
                ("want_g", neus.field.implicit_surface.encoding,
                 CS._ray_points(o, d, 36, 14), True)):
            res[key] = _shape(libs, x, enc._build_table(), enc.meta, want_g)
            print(f"[B6 {key}] {json.dumps(res[key])}")
    return res


def _render_launches(libs: dict, dev, neus) -> dict:
    """B6 on the inputs of each of its launches in one F=2 NeuS render."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    o, d = _rays(dev, CS.N_RAYS)
    rec, fwd = [], B._fwd_cuda

    def keep(x, table, meta, want_g=False):
        rec.append((x.clone(), table.clone(), meta, want_g))
        return fwd(x, table, meta, want_g)

    B._fwd_cuda = keep
    try:
        with torch.no_grad():
            neus.ray_query(CS._tested(neus, o, d))
        torch.cuda.synchronize()
    finally:
        B._fwd_cuda = fwd
    out = []
    for k, (x, table, meta, want_g) in enumerate(rec):
        n, L = x.shape[0], meta.n_levels
        r = {"n": n, "form": "want_g" if want_g else "y"}
        _same(r, "y_bitwise_vs_parent", _fwd(libs["brick_new"], x, table,
                                             meta),
              _fwd(libs["brick_parent"], x, table, meta))
        r["ms"] = _turns({m: (lambda m=m: _fwd(libs[m], x, table, meta))
                          for m in NAMES}, NAMES + NAMES[::-1])
        r["bound_ms"], r["bound_by"] = CS._b6_bound(n, L, table.numel())
        print(f"[B6 render launch {k}] {json.dumps(r)}")
        out.append(r)
    return {"launches": out}


def _in_path(libs: dict, dev, run, names=TWO) -> dict:
    """B6's device time and the pass's inside `run()` (three passes under
    torch.profiler), with `lotd_brick._fwd_cuda` routed to each library of
    `names` in turns; and whether the passes' outputs are the same bits
    under every library."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    orig, out, outputs = B._fwd_cuda, {}, {}

    def one(name):
        def via(x, table, meta, want_g=False):
            return _fwd(libs[name], B.aligned(x), B.aligned(table), meta,
                        want_g)
        B._fwd_cuda = via
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    got = run()
                torch.cuda.synchronize()
        finally:
            B._fwd_cuda = orig
        outputs.setdefault(name, got)
        t = {"b6": 0.0, "b6_events": 0, "pass": 0.0}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA or \
                    getattr(ev, "is_user_annotation", False):
                continue
            ms = getattr(ev, "self_device_time_total", 0.0) / 3e3
            t["pass"] += ms
            if B6 in ev.key:
                t["b6"] += ms
                t["b6_events"] += ev.count / 3
        if not t["b6"]:
            raise RuntimeError("no brick_fwd_kernel in the pass's profile")
        for k, v in t.items():
            out.setdefault(k, {}).setdefault(name, []).append(v)

    for name in tuple(names) + tuple(names)[::-1]:
        one(name)
    a, b = (outputs[n] for n in names[:2])
    out["outputs_bitwise_equal"] = all(
        torch.equal(a[k], b[k]) for k in a)
    return out


def _paths(libs: dict, dev, neus) -> dict:
    """B6 inside the F=2 NeuS render, its autograd nablas and its train
    step at it = 23."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    o, d = _rays(dev, CS.N_RAYS)
    res = {}

    def render():
        with torch.no_grad():
            rendered, _ = neus.ray_query(CS._tested(neus, o, d))
        return {k: v for k, v in rendered.items()
                if isinstance(v, torch.Tensor)}

    res["render"] = _in_path(libs, dev, render)
    x = (CS._ray_points(o, d, 36, 14) * 2.0 - 1.0).detach()

    def nablas():
        xr = x.clone().requires_grad_(True)
        (nab, ) = torch.autograd.grad(neus.forward_sdf(xr)["sdf"].sum(), xr)
        return {"nablas": nab}

    res["autograd_nablas"] = _in_path(libs, dev, nablas)

    # chip_smoke.py's path B model trained by its steps up to it = 23
    m = LoTDNeuSModel(**CS.NEUS_F2_CFG, seed=0)
    CS._seed_weights(m, m.field.implicit_surface.encoding, 3)
    m.populate()
    CS._seed_occupancy(m)
    opt, gen = CS._train_state(m, dev)
    it = CS.N_WARMUP_STEPS + CS.N_STEPS + 1
    with torch.enable_grad():
        for i in range(1, it):
            CS._train_step(m, opt, gen, o, d, i)

    def step():
        g = torch.Generator(device=dev).manual_seed(9)
        m.training_before_per_step(it, g)
        with torch.enable_grad():
            loss = CS._step_loss(m, o, d, generator=g)
            loss.backward()
        m.zero_grad(set_to_none=True)
        return {"loss": loss.detach()}

    res["step"] = _in_path(libs, dev, step)
    res["step"]["it"] = it
    for k, v in res.items():
        print(f"[B6 in the {k}] {json.dumps(v)}")
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
    sass = {name: CS._sass_functions(paths[name]) for name in NAMES}
    res = {"device": smi,
           "sass": {name: {k: len(v) for k, v in code.items()
                           if B6 in k or any(u in k for u in UNCHANGED)}
                    for name, code in sass.items()}}

    def instrs(name, kernel):
        return [i for k, v in sass[name].items() if kernel in k for _, i in v]

    res["b7_b9_sass_same_as_parent"] = all(
        instrs("brick_new", k) == instrs("brick_parent", k) and
        instrs("brick_new", k) for k in UNCHANGED)
    print(f"[sass] {json.dumps(res['sass'])}; B7-B9 the parent's: "
          f"{res['b7_b9_sass_same_as_parent']}")
    libs = {n: _load(p) for n, p in paths.items()}
    neus, nerf = _models(dev)
    res["shapes"] = _shapes(libs, dev, neus, nerf)
    res["render_launches"] = _render_launches(libs, dev, neus)
    res["paths"] = _paths(libs, dev, neus)
    res["failed"] = _check(res)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
