#!/usr/bin/env python3
"""Time the parent commit's B3 and B5 kernels against this tree's, in
turns, on one card, with probes and rival forms, and compare their
outputs: the F=4 brick nablas B3 (`brick4_dydx`, `csrc/brick4.cu`) and
the occupancy gather B5 (`gather1d`, `csrc/gather1d.cu`). With `--bidx`
first, it only builds a parent's and this tree's `brick.cu` and holds
the null-bidx forms of B6 (both forms) and B8 bitwise against the
parent's (`b68_null_bidx_bitwise`), and the null-bidx B7 and B9 against
the parent's (`b79_null_bidx`): B7's dL/dx (from the want_g corners and
from the table) and B9's dL/dg_up and dL/dx bit for bit, their dL/dtable
within the atomics' tolerance (1e-5 of its largest entry: the sums'
order changes from run to run), each timed in turns (parent, this tree,
this tree, parent). An entry takes the forest's bidx where the source's
C entry names it, so the parent may come from before B6 and B8 took it
(70fc0b1) or from before B7 and B9 did (a40ce1c):

    python3 chip_ab.py --bidx _archive/parent/nr3d_lib_tpu_torch/csrc

    git archive <parent> nr3d_lib_tpu_torch/csrc | tar -x -C _archive/parent
    python3 chip_ab.py _archive/parent/nr3d_lib_tpu_torch/csrc

(`_archive/` is listed in `.gitignore`; run the second line where the
card is.) Builds, with the port's nvcc flags, into `_archive/ab_build/`,
one nvcc per library, all started together, each source with its own
directory's headers (`-I`): the parent's and this tree's `brick4.cu` and
`gather1d.cu`, and copies of them with text substitutions (`PROBES`), in
lieu of `ncu`. This tree's B3 is the parent's thread a point with its
loop over the levels unrolled (a template instance for L = 1..4), in
blocks of 64 of at most 56 registers. Its rivals, each giving the
parent's dx bit for bit:

- from the parent's source, the kernel and its C entry replaced whole,
  in level-major blocks (32 points x L levels, warp l at level l, the
  levels summed in the block in level order):
  - `b3_A`: a thread a (point, level) loading its 8 corner words from
    its own brick row, as B8 (`brick.cu`);
  - `b3_B_each`: corner-split, 8 lanes a (point, level) and lane k
    loading corner k, so that one load instruction serves 4 (point,
    level)s; each of the 8 lanes does the index math; the 8 products
    g.val go by shuffles to the group's first lane, which sums the
    corners in the parent's order;
  - `b3_B_bcast`: the same loads, the index math done once by the lane
    that owns the (point, level), its row and g_up broadcast by
    shuffles, the 8 products shuffled back to the owner;
  - `b3_B_smem`: the same loads, the index math done once; the rows and
    the corner words go through shared memory, and the owner does the
    parent's arithmetic on the words;
- from this tree's source: `b3_C_smem`, its thread a point with
  `b3_B_smem`'s corner-split loads (each warp's 32 points at all levels
  through shared memory); `b3_C_40`, its kernel without the 18 blocks an
  SM in its launch bounds (40 registers).

B3's probes (wrong outputs unless named): `b3_noloads` and
`b3_new_noloads`, each corner's word made from its slot, no table load
(what the index math and arithmetic cost); `b3_one_row` and
`b3_new_one_row`, every lane reading its corners from lane 0's brick
row with the same load instructions (what the lanes' scattered rows
cost); `b3_parent_64`, the parent in blocks of 64 threads, not 256
(right: what evening out the SMs' share gives alone).

This tree's B5 is the parent's (one lookup a thread). Its rivals, from
the parent's source, kernel and entry replaced (`_gather_form`): `b5_x4`
(4 lookups a thread, row and lane read as int4 and out written as
float4, the ragged tail by the last thread, a grid of at most one wave,
the flat index formed exactly in 64 bits), `b5_x4_i32` (its flat index
in 32 bits), `b5_x2` (2 a thread), `b5_x1_wave` (1 a thread in at most
one wave); its probes: `b5_x4_noload` (`b5_x4` writing the flat index
in place of the table read), `b5_empty` (the parent's grid, each thread
writing 0: the launch-and-store floor) and `b5_stream` (the parent's
grid, reading row and lane and writing their sum: the streams' floor).

Prints each library's ptxas registers of B3 and B5 and their SASS
instruction counts, and checks that B1 (both forms), B2 and B4 have the
parent's instruction lists. Then:

- B3 at the F=4 step's 147,456 points x 2 levels (`chip_smoke.py`'s
  seeded model, the render's meta [16, 64] Dense/Hash), in ray order and
  randomly permuted: dx bitwise the parent's (and every right rival's),
  within 1e-4 of the plain version, a permuted batch's dx the permuted
  dx; times in turns (parent, new, rivals and probes, the same
  reversed) and the bound; bitwise the parent's at the F=4 NeRF's meta
  [16, 64, 512] Dense/Hash/Hash (`experiments/bench_render.py:37-43`)
  and at L = 1 and L = 4, in both orders; and on the inputs the F=4
  render hands it, parent and new in turns;
- B5 at the F=4 render's 393,216 lookups into [4096, 64]: out bitwise the
  plain version's (and every right rival's), times in turns with the
  rivals, the probes and `values[row, lane]`'s; bitwise the plain
  version's at n = 1, 2, 3, 5 and 393,217 (every length mod 4), on
  `row[1:]` and `lane[1:]` views and on clamped out-of-range indices,
  under this tree's kernel and `b5_x4`;
- inside the paths (torch.profiler, ms per pass over three passes after
  a warm-up), with the wrapper routed in turns: `lotd_brick4._dydx_cuda`
  to the parent's or this tree's B3 in the F=4 NeuS render (1 launch)
  and train step (1); `occgrid_march.gather_rows_lanes` to the parent's
  B5 or `b5_x4` in the F=4 render, the F=2 NeuS render and the
  march_occ_compressed F=2 NeRF render (1 each); the kernel's device
  time and the pass's in each, and the pass's outputs bitwise equal
  under the two.

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
from typing import Optional

import numpy as np

REPO = Path(__file__).resolve().parent
BUILD = REPO / "_archive" / "ab_build"
NEW = REPO / "nr3d_lib_tpu_torch" / "csrc"

# --------- B6-B9 (brick.cu): the null-bidx forms' bits (`--bidx`)
B68F = "brick.cu"
ENTRIES = ("brick_fwd", "brick_bwd", "brick_dydx", "brick_bwd2")


def _takes_bidx(src: Path, entry: str) -> bool:
    """Whether a brick.cu's C entry `entry` takes the forest's bidx."""
    text = src.read_text()
    head = text[text.index(f"int {entry}("):]
    return "bidx" in head[:head.index(")")]

# --------------------------------------------------- B3 (brick4.cu)
B3F = "brick4.cu"
B3 = "brick4_dydx_kernel"
# the parent's kernel and C entry, each replaced whole by a rival form
B3_KERNEL = ("__global__ void brick4_dydx_kernel(",
             "// B4, the backward of B3.")
B3_ENTRY = ("// g_up [n,4L] f32, x [n,3] f32, table packed [rows,128], "
            "dx [n,3] f32.\nint brick4_dydx(",
            "// g_up [n,4L] f32, x [n,3] f32, table packed [rows,128], gg")
_SIG = """__global__ void brick4_dydx_kernel(const float4* __restrict__ g_up,
                                   const float* __restrict__ x,
                                   const uint2* __restrict__ table,
                                   const __grid_constant__ Brick4Meta meta,
                                   float* __restrict__ dx, long long n) {
"""
_HEAD = """  const int L = meta.n_levels;
  const long long p0 = (long long)blockIdx.x * BRICK4_POINTS;
  const int np = (int)min((long long)BRICK4_POINTS, n - p0);
  const int l = threadIdx.x >> 5, i = threadIdx.x & 31;
"""
_LOCATE = """    const float* xi = x + (p0 + i) * 3;
    const float xp[3] = {xi[0], xi[1], xi[2]};
    g = g_up[(p0 + i) * L + l];
    c = locate(xp, meta.lv[l]);
"""
_PARK = """#pragma unroll
    for (int a = 0; a < 3; ++a) ts[(l * BRICK4_POINTS + {p}) * 3 + a] = t[a];
"""
_LEVEL_SUM = """  __syncthreads();
  for (int k = threadIdx.x; k < np * 3; k += blockDim.x) {
    const int a = k % 3;
    float d = 0.f;
    for (int ll = 0; ll < L; ++ll)
      d = fmaf(ts[ll * BRICK4_POINTS * 3 + k],
               (float)(meta.lv[ll].res[a] - 2), d);
    dx[p0 * 3 + k] = d;
  }
}

"""
_TS = ("  __shared__ float ts[BRICK4_MAX_LEVELS * BRICK4_POINTS * 3];\n")


def _corners(word: str = "", h: str = "") -> str:
    """The parent's sum over the 8 corners of one (point, level) → t[3]:
    corner k's packed word is `word` (g·val computed here), or its g·val
    is `h` (computed in another lane)."""
    if word:
        h = f"""      float f[4];
      unpack4({word}, f);
      const float h = g.x * f[0] + g.y * f[1] + g.z * f[2] + g.w * f[3];
"""
    else:
        h = f"      const float h = {h};\n"
    return """    float s[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a][0] = 1.f - c.frac[a];
      s[a][1] = c.frac[a];
    }
    float t[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
""" + h + """      t[0] += (b0 ? h : -h) * s[1][b1] * s[2][b2];
      t[1] += (b1 ? h : -h) * s[0][b0] * s[2][b2];
      t[2] += (b2 ? h : -h) * s[0][b0] * s[1][b1];
    }
"""


def _entry(smem: str) -> str:
    return f"""// g_up [n,4L] f32, x [n,3] f32, table packed [rows,128], dx [n,3] f32.
int brick4_dydx(const void* g_up, const void* x, const void* table,
                Brick4Meta meta, void* dx, long long n, void* stream) {{
  const int L = meta.n_levels;
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0 && L == 0)  // no level: dx is 0 (no block of 0 threads)
    return (int)cudaMemsetAsync(dx, 0, sizeof(float) * n * 3, st);
  if (n > 0)
    brick4_dydx_kernel<<<n_blocks(n, BRICK4_POINTS), 32 * L, {smem}, st>>>(
        (const float4*)g_up, (const float*)x, (const uint2*)table, meta,
        (float*)dx, n);
  return (int)cudaGetLastError();
}}

"""


FORM_A = _SIG + _TS + _HEAD + """  if (i < np) {
    Located c;
    float4 g;
""" + _LOCATE + """    const uint2* rowp = table + (long long)c.row * 64 + c.vert0;
""" + _corners(word="__ldg(rowp + b0 * 16 + b1 * 4 + b2)") + \
    _PARK.replace("{p}", "i") + "  }\n" + _LEVEL_SUM

FORM_B_EACH = _SIG + _TS + _HEAD + """  const int q = i >> 3, kc = i & 7;
  for (int r = 0; r < 8; ++r) {
    const int j = 4 * r + q;
    Located c;
    float h = 0.f;
    if (j < np) {
      const float* xj = x + (p0 + j) * 3;
      const float xp[3] = {xj[0], xj[1], xj[2]};
      const float4 g = g_up[(p0 + j) * L + l];
      c = locate(xp, meta.lv[l]);
      float f[4];
      unpack4(__ldg(table + c.row * 64 + c.vert0 + corner_off(kc)), f);
      h = g.x * f[0] + g.y * f[1] + g.z * f[2] + g.w * f[3];
    }
    float hv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      hv[k] = __shfl_sync(0xffffffffu, h, (q << 3) + k);
    if (j < np && kc == 0) {
""" + _corners(h="hv[k]") + _PARK.replace("{p}", "j") + """    }
  }
""" + _LEVEL_SUM

FORM_B_BCAST = _SIG + _TS + _HEAD + """  Located c;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  int base = 0;
  if (i < np) {
""" + _LOCATE + """    base = c.row * 64 + c.vert0;
  }
  const int q = i >> 3, kc = i & 7;
  float hv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = 4 * r + q;
    const int bj = __shfl_sync(0xffffffffu, base, j);
    const float gx = __shfl_sync(0xffffffffu, g.x, j),
                gy = __shfl_sync(0xffffffffu, g.y, j),
                gz = __shfl_sync(0xffffffffu, g.z, j),
                gw = __shfl_sync(0xffffffffu, g.w, j);
    float h = 0.f;
    if (j < np) {
      float f[4];
      unpack4(__ldg(table + bj + corner_off(kc)), f);
      h = gx * f[0] + gy * f[1] + gz * f[2] + gw * f[3];
    }
    // lane 4 r + m owns point 4 r + m, whose corner k lane 8 m + k holds
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v = __shfl_sync(0xffffffffu, h, ((i & 3) << 3) + k);
      if ((i >> 2) == r) hv[k] = v;
    }
  }
  if (i < np) {
""" + _corners(h="hv[k]") + _PARK.replace("{p}", "i") + "  }\n" + _LEVEL_SUM

FORM_B_SMEM = _SIG + """  extern __shared__ uint4 sm[];
""" + _HEAD + """  // [L][32][5] uint4: a (point, level)'s 8 words and a uint4 of padding,
  // then [L][32] int rows, then [L][32][3] float t
  uint4* ws = sm + l * BRICK4_POINTS * 5;
  int* bs = reinterpret_cast<int*>(sm + L * BRICK4_POINTS * 5) +
            l * BRICK4_POINTS;
  float* ts = reinterpret_cast<float*>(sm + L * BRICK4_POINTS * 5) +
              L * BRICK4_POINTS;
  Located c;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < np) {
""" + _LOCATE + """    bs[i] = c.row * 64 + c.vert0;
  }
  __syncwarp();
  {
    const int q = i >> 3, kc = i & 7;
    uint2* w2 = reinterpret_cast<uint2*>(ws);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = 4 * r + q;
      if (j < np) w2[j * 10 + kc] = __ldg(table + bs[j] + corner_off(kc));
    }
  }
  __syncwarp();
  if (i < np) {
    uint2 v[8];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint4 u = ws[i * 5 + m];
      v[2 * m] = make_uint2(u.x, u.y);
      v[2 * m + 1] = make_uint2(u.z, u.w);
    }
""" + _corners(word="v[k]") + _PARK.replace("{p}", "i") + "  }\n" + \
    _LEVEL_SUM
_SMEM_B = "(size_t)L * BRICK4_POINTS * 96"

# this tree's B3 (a thread a point, the levels a template parameter) with
# the corner-split loads of `b3_B_smem`: each warp's 32 points at all
# levels, the rows and words of every level through shared memory
C_NEW = "template <int L>\n__global__ void __launch_bounds__(64, 18)"
FORM_C_SMEM = """template <int L>
__global__ void __launch_bounds__(64) brick4_dydx_kernel(
    const float4* __restrict__ g_up, const float* __restrict__ x,
    const uint2* __restrict__ table, const __grid_constant__ Brick4Meta meta,
    float* __restrict__ dx, long long n) {
  __shared__ uint4 wsb[2][L][BRICK4_POINTS * 5];
  __shared__ int bsb[2][L][BRICK4_POINTS];
  const int w = threadIdx.x >> 5, i = threadIdx.x & 31;
  const long long p0 = ((long long)blockIdx.x * 2 + w) * BRICK4_POINTS;
  if (p0 >= n) return;
  const int np = (int)min((long long)BRICK4_POINTS, n - p0);
  Located cl[L];
  float4 gl[L];
  if (i < np) {
    const float* xi = x + (p0 + i) * 3;
    const float xp[3] = {xi[0], xi[1], xi[2]};
#pragma unroll
    for (int l = 0; l < L; ++l) {
      cl[l] = locate(xp, meta.lv[l]);
      gl[l] = g_up[(p0 + i) * L + l];
      bsb[w][l][i] = cl[l].row * 64 + cl[l].vert0;
    }
  }
  __syncwarp();
  const int q = i >> 3, kc = i & 7;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    uint2* w2 = reinterpret_cast<uint2*>(wsb[w][l]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = 4 * r + q;
      if (j < np) w2[j * 10 + kc] = __ldg(table + bsb[w][l][j] + corner_off(kc));
    }
  }
  __syncwarp();
  if (i < np) {
    float d[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const Located c = cl[l];
      const float4 g = gl[l];
      uint2 v[8];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint4 u = wsb[w][l][i * 5 + m];
        v[2 * m] = make_uint2(u.x, u.y);
        v[2 * m + 1] = make_uint2(u.z, u.w);
      }
""" + _corners(word="v[k]") + """#pragma unroll
      for (int a = 0; a < 3; ++a) d[a] += t[a] * (float)(meta.lv[l].res[a] - 2);
    }
    dx[(p0 + i) * 3] = d[0];
    dx[(p0 + i) * 3 + 1] = d[1];
    dx[(p0 + i) * 3 + 2] = d[2];
  }
}

"""

B3_FORMS = {"b3_A": (FORM_A, "0"), "b3_B_each": (FORM_B_EACH, "0"),
            "b3_B_bcast": (FORM_B_BCAST, "0"),
            "b3_B_smem": (FORM_B_SMEM, _SMEM_B)}
B3_LOAD = "unpack4(__ldg(rowp + b0 * 16 + b1 * 4 + b2), f);"
B3_NO_LOAD = B3_LOAD.replace(
    "__ldg(rowp + b0 * 16 + b1 * 4 + b2)",
    "make_uint2((unsigned)(c.row * 64 + c.vert0 + b0 * 16 + b1 * 4 + b2), "
    "0x3f803f80u)")
B3_ROW = ("    const float4 g = g_up[p * L + l];\n"
          "    const uint2* rowp = table + (long long)c.row * 64 + c.vert0;")
B3_ONE_ROW = B3_ROW.replace("c.row", "__shfl_sync(0xffffffffu, c.row, 0)")
B3_LAUNCH = ("    const int threads = 256;\n"
             "    const long long blocks = (n + threads - 1) / threads;\n"
             "    brick4_dydx_kernel<<<")
# ------------------------------------------------- B5 (gather1d.cu)
B5F = "gather1d.cu"
B5 = "gather1d_kernel"
B5_PARENT_BODY = """  long long f = (long long)row[i] * n_cols + lane[i];
  f = f < 0 ? 0 : (f >= n_values ? n_values - 1 : f);
  out[i] = __ldg(values + f);"""
# the parent's kernel and C entry, replaced whole by a rival form
B5_ALL = ("__global__ void gather1d_kernel(", '}  // extern "C"')


def _gather_form(per: int, threads: int, flat: str = "exact",
                 read: bool = True) -> str:
    """B5 with `per` lookups a thread (row and lane read as int`per`, out
    written as float`per`; the last thread takes the ragged n mod `per`
    one by one) in blocks of `threads`, the grid at most one wave of the
    card (a larger n strides). The flat index row * n_cols + lane is
    formed exactly (a 32 x 32 -> 64-bit product) or, `flat` = "i32", in
    32 bits (exact while it fits an int); without `read`, the clamped
    index is written in place of the table's value."""
    vec = {1: ("int", "float"), 2: ("int2", "float2"),
           4: ("int4", "float4")}[per]
    index = ("  const long long f = (long long)r * n_cols + c;\n"
             "  const int k = f < 0 ? 0 : (f >= n_values ? n_values - 1 : "
             "(int)f);\n" if flat == "exact" else
             "  const int k = min(max(r * n_cols + c, 0), n_values - 1);\n")
    value = "__ldg(values + k)" if read else "(float)k"
    if per == 1:
        body = ("      out[t] = lookup(values, __ldg(row + t), __ldg(lane + t),"
                " n_cols, n_values);\n")
    else:
        comps = ", ".join(f"lookup(values, r.{a}, c.{a}, n_cols, n_values)"
                          for a in "xyzw"[:per])
        body = (f"      const {vec[0]} r = __ldg(row + t), c = __ldg(lane + "
                f"t);\n      out[t] = make_{vec[1]}({comps});\n")
    return f"""constexpr int GATHER_THREADS = {threads};

__device__ __forceinline__ float lookup(const float* __restrict__ values,
                                        int r, int c, int n_cols,
                                        int n_values) {{
{index}  return {value};
}}

__global__ void gather1d_kernel(const float* __restrict__ values,
                                const {vec[0]}* __restrict__ row,
                                const {vec[0]}* __restrict__ lane,
                                {vec[1]}* __restrict__ out, int n, int n_cols,
                                int n_values) {{
  const int nv = n / {per};
  const int n_items = nv + (nv * {per} != n);  // thread nv: the ragged tail
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n_items;
       t += gridDim.x * blockDim.x) {{
    if (t < nv) {{
{body}    }} else {{
      const int* r = reinterpret_cast<const int*>(row);
      const int* c = reinterpret_cast<const int*>(lane);
      float* o = reinterpret_cast<float*>(out);
      for (int i = {per} * nv; i < n; ++i)
        o[i] = lookup(values, r[i], c[i], n_cols, n_values);
    }}
  }}
}}

extern "C" {{

int gather1d(const void* values, const void* row, const void* lane,
             void* out, long long n, int n_rows, int n_cols, void* stream) {{
  static int sms = 0, per_sm = 0;  // the card's wave, asked once
  if (n > 0) {{
    if (sms == 0) {{
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather1d_kernel,
                                                    GATHER_THREADS, 0);
    }}
    const long long items = (n + {per - 1}) / {per};
    const long long wave = (long long)sms * per_sm;
    const long long need = (items + GATHER_THREADS - 1) / GATHER_THREADS;
    gather1d_kernel<<<(unsigned)(need < wave ? need : wave), GATHER_THREADS,
                      0, (cudaStream_t)stream>>>(
        (const float*)values, (const {vec[0]}*)row, (const {vec[0]}*)lane,
        ({vec[1]}*)out, (int)n, n_cols, n_rows * n_cols);
  }}
  return (int)cudaGetLastError();
}}

"""


B5_FORMS = {"b5_x4": _gather_form(4, 128),
            "b5_x4_i32": _gather_form(4, 128, flat="i32"),
            "b5_x4_noload": _gather_form(4, 128, read=False),
            "b5_x2": _gather_form(2, 128),
            "b5_x1_wave": _gather_form(1, 256)}

# name → (source file, [(old, new)], built from the parent's copy); an
# old text is a string found once, or a (start, end) pair: the span from
# start up to end, each found once
PROBES = {
    **{name: (B3F, [(B3_KERNEL, form), (B3_ENTRY, _entry(smem))], True)
       for name, (form, smem) in B3_FORMS.items()},
    "b3_C_smem": (B3F, [((C_NEW, B3_KERNEL[1]), FORM_C_SMEM)], False),
    "b3_C_40": (B3F, [(C_NEW, C_NEW.replace("(64, 18)", "(64)"))], False),
    "b3_noloads": (B3F, [(B3_LOAD, B3_NO_LOAD)], True),
    "b3_new_noloads": (B3F, [(B3_LOAD, B3_NO_LOAD)], False),
    # the paths' batches fill whole warps, so no lane that the shuffle
    # reads has returned
    "b3_one_row": (B3F, [(B3_ROW, B3_ONE_ROW)], True),
    "b3_new_one_row": (B3F, [(B3_ROW, B3_ONE_ROW)], False),
    "b3_parent_64": (B3F, [(B3_LAUNCH, B3_LAUNCH.replace("256", "64"))],
                     True),
    **{name: (B5F, [(B5_ALL, form)], True)
       for name, form in B5_FORMS.items()},
    "b5_empty": (B5F, [(B5_PARENT_BODY, "  out[i] = 0.f;")], True),
    "b5_stream": (B5F, [(B5_PARENT_BODY,
                         "  out[i] = (float)(row[i] + lane[i]);")], True),
}
B3_NAMES = ("b3_parent", "b3_new", *(k for k in PROBES if k[:3] == "b3_"))
B5_NAMES = ("b5_parent", "b5_new", *(k for k in PROBES if k[:3] == "b5_"))
# the libraries whose outputs are right
B3_EXACT = ("b3_new", *B3_FORMS, "b3_C_smem", "b3_C_40", "b3_parent_64")
B5_EXACT = ("b5_new", "b5_x4", "b5_x4_i32", "b5_x2", "b5_x1_wave")
# B5 kept the parent's kernel: in the paths it is held against the
# candidate form
B5_IN_PATH = ("b5_parent", "b5_x4")
UNCHANGED = {"b3": ("brick4_fwd_kernel", "brick4_fwd_g_kernel",
                    "brick4_bwd_kernel", "brick4_bwd2_kernel")}


def _substitute(text: str, old, new: str, what: str) -> str:
    if isinstance(old, tuple):
        start, end = old
        if text.count(start) != 1 or text.count(end) != 1 or \
                text.index(end) < text.index(start):
            raise RuntimeError(f"{what}: the span it replaces is not in it "
                               f"once: {old!r}")
        return text[:text.index(start)] + new + text[text.index(end):]
    if text.count(old) != 1:
        raise RuntimeError(f"{what}: the text it replaces is not in it once: "
                           f"{old!r}")
    return text.replace(old, new)


def _probe(name: str, base: Path, fname: str, subs) -> tuple:
    """A copy of the sources in `base` in BUILD/name with each (old, new)
    of `subs` replaced in `fname`; (the copy's source, its -I dir)."""
    out = BUILD / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(base, out)
    text = (out / fname).read_text()
    for old, new in subs:
        text = _substitute(text, old, new, f"{name} ({fname})")
    (out / fname).write_text(text)
    return out / fname, out


def _nvcc_all(sources: dict) -> None:
    """One nvcc per library, all started together; prints ptxas'
    registers of B3's and B5's instances."""
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
            elif "registers" in line and (B3 in entry or B5 in entry):
                print(f"[ptxas {name}] {entry[:40]}: {line.strip()}")


def _build() -> dict:
    parent = Path(sys.argv[1]).resolve()
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = {}
    for tag, fname in (("b3", B3F), ("b5", B5F)):
        sources[f"{tag}_parent"] = (parent / fname, parent)
        sources[f"{tag}_new"] = (NEW / fname, NEW)
    sources.update({name: _probe(name, parent if from_parent else NEW,
                                 fname, subs)
                    for name, (fname, subs, from_parent) in PROBES.items()})
    _nvcc_all(sources)
    return {name: BUILD / f"lib{name}.so" for name in sources}


def _load(path: Path, src: Optional[Path] = None) -> ctypes.CDLL:
    """A built library with its entries' argtypes; `src`: the brick.cu it
    was built from (whether its entries take the forest's bidx)."""
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    vp, n = ctypes.c_void_p, ctypes.c_longlong
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    lib = ctypes.CDLL(str(path))
    if path.name.startswith("libb68"):
        # an entry takes the forest's bidx (and B7 and B9 the table's
        # block count) after the table where its source names it
        b = {e: _takes_bidx(src, e) for e in ENTRIES}
        b1 = lambda e: [vp] if b[e] else []            # noqa: E731
        b2 = lambda e: [vp, n] if b[e] else []         # noqa: E731
        lib.brick_fwd.argtypes = [vp, vp, *b1("brick_fwd"), B._Meta, vp, vp,
                                  n, vp]
        lib.brick_dydx.argtypes = [vp, vp, vp, *b1("brick_dydx"), B._Meta,
                                   vp, n, vp]
        lib.brick_bwd.argtypes = [vp, vp, vp, vp, *b2("brick_bwd"), B._Meta,
                                  vp, vp, n, vp]
        lib.brick_bwd2.argtypes = [vp, vp, vp, vp, *b2("brick_bwd2"),
                                   B._Meta, vp, vp, vp, n, vp]
        for e in ENTRIES:
            getattr(lib, e).restype = ctypes.c_int
        lib.takes_bidx = b
    elif path.name.startswith("libb3"):
        lib.brick4_dydx.argtypes = [vp, vp, vp, B4._Meta, vp, n, vp]
        lib.brick4_dydx.restype = ctypes.c_int
    else:
        lib.gather1d.argtypes = [vp, vp, vp, vp, n, ctypes.c_int,
                                 ctypes.c_int, vp]
        lib.gather1d.restype = ctypes.c_int
    return lib


def _dydx(lib, g_up, x, packed, meta):
    """B3 of one library → dx [N, 3] (the wrapper's `_dydx_cuda`)."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    g_up, x = B4.aligned(g_up), B4.aligned(x)
    dx = torch.empty_like(x)
    Bu.check(lib.brick4_dydx(g_up.data_ptr(), x.data_ptr(), packed.data_ptr(),
                             B4.c_meta(meta, B4._Meta), dx.data_ptr(),
                             x.shape[0], Bu.stream_ptr(x.device)),
             "brick4_dydx")
    return dx


def _gather(lib, values, row, lane):
    """B5 of one library → values[row, lane] (the wrapper
    `gather_rows_lanes` on a CUDA table)."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    shape = row.shape
    values = B.aligned(values)
    row = B.aligned(row.reshape(-1).to(torch.int32))
    lane = B.aligned(lane.reshape(-1).to(torch.int32))
    out = torch.empty(row.shape, device=values.device, dtype=torch.float32)
    Bu.check(lib.gather1d(values.data_ptr(), row.data_ptr(), lane.data_ptr(),
                          out.data_ptr(), row.numel(), values.shape[0],
                          values.shape[1], Bu.stream_ptr(values.device)),
             "gather1d")
    return out.reshape(shape)


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
    """`chip_smoke.py`'s F=4 NeuS, F=2 NeuS and F=2 NeRF, seeded as it
    seeds them."""
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.models.model_base import (LoTDNeRFModel,
                                                      LoTDNeuSModel)

    out = []
    for cls, cfg, enc, seed in (
            (LoTDNeuSModel, CS.PROD_CFG,
             lambda m: m.field.implicit_surface.encoding, 1),
            (LoTDNeuSModel, CS.NEUS_F2_CFG,
             lambda m: m.field.implicit_surface.encoding, 3),
            (LoTDNeRFModel, CS.NERF_CFG, lambda m: m.field.encoding, 2)):
        m = cls(**cfg, seed=0)
        CS._seed_weights(m, enc(m), seed)
        m.populate()
        CS._seed_occupancy(m)
        out.append(m)
    return out


def _rays(dev, n: int):
    import torch
    import chip_smoke as CS

    return tuple(torch.from_numpy(a).to(dev) for a in CS._rays(n, seed=0))


def _ray_inputs(dev, n: int, seed: int):
    """Points in [0,1]^3 along seeded rays, sorted along each ray (the
    GPU tests' `_pc_ray_points`)."""
    import torch

    r = np.random.default_rng(seed)
    n_rays = -(-n // 96)
    o = r.uniform(0.0, 1.0, (n_rays, 1, 3))
    v = r.normal(size=(n_rays, 1, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    t = np.sort(r.uniform(0.0, 0.8, (n_rays, 96, 1)), 1)
    x = np.clip(o + v * t, 0.0, 1.0).reshape(-1, 3)[:n]
    return torch.from_numpy(x.astype(np.float32)).to(dev)


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


def _b3(libs: dict, dev, model) -> dict:
    """B3 at the F=4 step's shape in both orders, its bits at the F=4
    NeRF's meta and at L = 1 and 4, and on the F=4 render's own
    inputs."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    o, d = _rays(dev, CS.N_RAYS)
    enc = model.field.implicit_surface.encoding
    meta = enc.meta
    two = ("b3_parent", "b3_new")
    with torch.no_grad():
        table = enc._build_table()
        packed = B4.pack_table4(table)
        x = CS._ray_points(o, d, 36, seed=3)                # 147,456
        g = torch.randn(x.shape[0], 4 * meta.n_levels, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(4))
        perm = torch.randperm(x.shape[0], device=dev,
                              generator=torch.Generator(dev).manual_seed(18))
        plain = B4.brick4_nablas_xla(g, x, table, meta)
        r = {"n": x.shape[0], "levels": meta.n_levels,
             "rows": meta.total_rows}
        for order, xx, gg in (("ray", x, g), ("permuted", x[perm].contiguous(),
                                             g[perm].contiguous())):
            out = {m: _dydx(libs[m], gg, xx, packed, meta)
                   for m in ("b3_parent", *B3_EXACT)}
            for m in B3_EXACT:
                _same(r, f"{order}_{m}_bitwise_vs_parent", out[m],
                      out["b3_parent"])
            if order == "ray":
                ray_dx = out["b3_new"]
                r["dx_err"] = float((ray_dx - plain).abs().max())
                r["dx_tol"] = 1e-4 + 1e-4 * float(plain.abs().max())
            else:
                _same(r, "permuted_dx_is_the_permuted_dx", out["b3_new"],
                      ray_dx[perm])
            r[f"{order}_ms"] = _turns(
                {m: (lambda m=m, a=xx, b=gg: _dydx(libs[m], b, a, packed,
                                                   meta))
                 for m in B3_NAMES}, B3_NAMES + B3_NAMES[::-1])
        r["bound_ms"], r["bound_by"] = CS._b3_bound(
            x.shape[0], meta.n_levels, packed.numel() * 4)
        res = {"f4_step": r}
        print(f"[B3 f4_step] {json.dumps(r)}")
        # the F=4 NeRF's meta, L = 1 and L = 4: bits only
        for key, lod, types in (
                ("nerf_3_levels", [16, 64, 512], ["Dense", "Hash", "Hash"]),
                ("one_level", [16], ["Dense"]),
                ("four_levels", [16, 32, 64, 128],
                 ["Dense", "Dense", "Hash", "Hash"])):
            mt = B4.make_brick4_meta(lod, types, 4096)
            rng = np.random.default_rng(len(lod) + 50)
            xs = _ray_inputs(dev, 96 * 1001, len(lod) + 51)
            tb = torch.from_numpy(rng.uniform(
                -0.1, 0.1, (mt.total_rows, 256)).astype(np.float32)).to(dev)
            gs = torch.from_numpy(rng.normal(
                size=(xs.shape[0], 4 * len(lod))).astype(np.float32)).to(dev)
            pk = B4.pack_table4(tb)
            pm = torch.from_numpy(rng.permutation(xs.shape[0])).to(dev)
            for order, xx, gg in (("ray", xs, gs), ("permuted",
                                                   xs[pm].contiguous(),
                                                   gs[pm].contiguous())):
                _same(res, f"{key}_{order}_bitwise_vs_parent",
                      _dydx(libs["b3_new"], gg, xx, pk, mt),
                      _dydx(libs["b3_parent"], gg, xx, pk, mt))
        launches = []
        for args in _recorded_calls(model, o, d, B4, "_dydx_cuda"):
            ga, xa, pa, mt = args[:4]
            # as the wrapper hands them to the kernel, once, out of the
            # timed calls
            ga, xa = B4.aligned(ga), B4.aligned(xa)
            r = {"n": int(xa.shape[0])}
            _same(r, "dx_bitwise_vs_parent", _dydx(libs["b3_new"], ga, xa,
                                                   pa, mt),
                  _dydx(libs["b3_parent"], ga, xa, pa, mt))
            r["ms"] = _turns({m: (lambda m=m: _dydx(libs[m], ga, xa, pa, mt))
                              for m in two}, two + two[::-1])
            r["bound_ms"] = CS._b3_bound(r["n"], mt.n_levels,
                                         pa.numel() * 4)[0]
            launches.append(r)
            print(f"[B3 render launch {len(launches) - 1}] {json.dumps(r)}")
        res["render_launches"] = launches
    return res


def _b68(libs: dict, dev, neus2, nerf) -> dict:
    """B6 (both forms) and B8 with a null bidx against the parent's
    (which has no bidx argument): y, the corner values and dx bit for
    bit at the F=2 NeuS's and NeRF's metas, on points along rays and on
    the F=2 NeuS render's own B6 inputs."""
    import torch
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    def run(name, x, table, meta, g):
        lib, st = libs[name], Bu.stream_ptr(dev)
        nb = [None] if lib.takes_bidx["brick_fwd"] else []
        n, L = x.shape[0], meta.n_levels
        y = torch.empty((n, 2 * L), device=dev)
        yg = torch.empty_like(y)
        cs = torch.empty((n, L, 8, 2), device=dev)
        dx = torch.empty_like(x)
        m = B.c_meta(meta)
        for err in (
                lib.brick_fwd(x.data_ptr(), table.data_ptr(), *nb, m,
                              y.data_ptr(), None, n, st),
                lib.brick_fwd(x.data_ptr(), table.data_ptr(), *nb, m,
                              yg.data_ptr(), cs.data_ptr(), n, st),
                lib.brick_dydx(g.data_ptr(), x.data_ptr(), table.data_ptr(),
                               *nb, m, dx.data_ptr(), n, st)):
            Bu.check(err, name)
        torch.cuda.synchronize()
        return y, yg, cs, dx

    cases = []
    for what, enc, x in (
            ("neus", neus2.field.implicit_surface.encoding,
             _ray_inputs(dev, 147_456, 61)),
            ("nerf", nerf.field.encoding, _ray_inputs(dev, 196_608, 62))):
        cases.append((what, enc.meta, enc._build_table().detach(), x))
    o, d = _rays(dev, 4096)
    for k, args in enumerate(_recorded_calls(neus2, o, d, B, "_fwd_cuda")):
        x, table, meta = args[:3]
        cases.append((f"neus render launch {k}", meta, table, x))
    res = {}
    with torch.no_grad():
        for what, meta, table, x in cases:
            x, table = B.aligned(x), B.aligned(table)
            gen = torch.Generator(device=dev).manual_seed(63)
            g = torch.randn((x.shape[0], 2 * meta.n_levels), device=dev,
                            generator=gen)
            outs = [run(n, x, table, meta, g)
                    for n in ("b68_parent", "b68_new")]
            same = all(torch.equal(a, b) for a, b in zip(*outs))
            print(f"[b68 null bidx] {what}: {x.shape[0]:,} points x "
                  f"{meta.n_levels} levels; y, want_g y and corners, dx "
                  f"bitwise the parent's: {same}")
            res[what] = same
    return res


def _b79(libs: dict, dev, neus2, nerf) -> dict:
    """B7 (without dL/dx, with it from the want_g corners and from the
    table) and B9 (with and without dL/dx) with a null bidx against the
    parent's: dL/dx and dL/dg_up bit for bit, dL/dtable within 1e-5 of
    its largest entry (atomics), at the F=2 NeuS's and NeRF's metas on
    points along rays; each timed in turns."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import _build as Bu
    from nr3d_lib_tpu_torch.ops import lotd_brick as B

    def bwd(name, x, g, corners, table, meta, need_dx):
        lib, st = libs[name], Bu.stream_ptr(dev)
        nb = [None, 1] if lib.takes_bidx["brick_bwd"] else []
        dtab = torch.empty((meta.total_rows, 128), device=dev)
        dx = torch.empty_like(x) if need_dx else None
        Bu.check(lib.brick_bwd(x.data_ptr(), g.data_ptr(), B.ptr(corners),
                               B.ptr(table), *nb, B.c_meta(meta),
                               dtab.data_ptr(), B.ptr(dx), x.shape[0], st),
                 name)
        return dx, dtab

    def bwd2(name, g, x, table, gg, meta, need_dx):
        lib, st = libs[name], Bu.stream_ptr(dev)
        nb = [None, 1] if lib.takes_bidx["brick_bwd2"] else []
        dg = torch.empty_like(g)
        dtab = torch.empty((meta.total_rows, 128), device=dev)
        dx = torch.empty_like(x) if need_dx else None
        Bu.check(lib.brick_bwd2(g.data_ptr(), x.data_ptr(), table.data_ptr(),
                                gg.data_ptr(), *nb, B.c_meta(meta),
                                dg.data_ptr(), dtab.data_ptr(), B.ptr(dx),
                                x.shape[0], st), name)
        return dg, dx, dtab

    res = {}
    with torch.no_grad():
        for what, enc, x in (
                ("neus", neus2.field.implicit_surface.encoding,
                 _ray_inputs(dev, 147_456, 71)),
                ("nerf", nerf.field.encoding, _ray_inputs(dev, 196_608, 72))):
            meta, table = enc.meta, B.aligned(enc._build_table().detach())
            x = B.aligned(x)
            gen = torch.Generator(device=dev).manual_seed(73)
            g = torch.randn((x.shape[0], 2 * meta.n_levels), device=dev,
                            generator=gen)
            gg = torch.randn((x.shape[0], 3), device=dev, generator=gen)
            corners = B.aligned(B._fwd_cuda(x, table, meta, want_g=True)[1])
            forms = {
                "b7": lambda n: bwd(n, x, g, None, None, meta, False),
                "b7_dx_corners": lambda n: bwd(n, x, g, corners, None, meta,
                                               True),
                "b7_dx_table": lambda n: bwd(n, x, g, None, table, meta,
                                             True),
                "b9": lambda n: bwd2(n, g, x, table, gg, meta, False),
                "b9_dx": lambda n: bwd2(n, g, x, table, gg, meta, True)}
            row = {}
            for form, call in forms.items():
                outs = {n: call(n) for n in ("b68_parent", "b68_new")}
                torch.cuda.synchronize()
                par, new = outs["b68_parent"], outs["b68_new"]
                bits = all((a is None and b is None) or torch.equal(a, b)
                           for a, b in zip(par[:-1], new[:-1]))
                tol = 1e-5 * float(par[-1].abs().max())
                err = float((par[-1] - new[-1]).abs().max())
                ms = {n: [] for n in outs}
                for n in ("b68_parent", "b68_new", "b68_new", "b68_parent"):
                    ms[n].append(CS._time_ms(lambda: call(n)))
                ms = {n: min(v) for n, v in ms.items()}
                print(f"[b79 null bidx] {what} {form}: {x.shape[0]:,} "
                      f"points x {meta.n_levels} levels; dL/dx and "
                      f"dL/dg_up bitwise the parent's: {bits}; dL/dtable "
                      f"max|new-parent| {err:.3e} (tolerance {tol:.3e}); "
                      f"parent {ms['b68_parent']:.4f} ms, this tree "
                      f"{ms['b68_new']:.4f} ms (in turns)")
                row[form] = {"bitwise": bits, "dtab_err": err,
                             "dtab_tol": tol,
                             "ms_parent": ms["b68_parent"],
                             "ms_new": ms["b68_new"]}
            res[what] = row
    return res


def _b5(libs: dict, dev, model) -> dict:
    """B5 at the F=4 render's lookups (bits against the plain version,
    times in turns with its probes and `values[row, lane]`), and its bits
    at every tail length, on misaligned views and clamped indices."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import gather1d as G
    from nr3d_lib_tpu_torch.ops import occgrid_march as OM

    o, d = _rays(dev, CS.N_RAYS)
    with torch.no_grad():
        # chip_smoke.py's B5 phase: the march's 96 steps a ray
        rt = model.ray_test(o, d)
        o_n, d_n = model.space.normalize_rays(o, d)
        t5, _, _ = OM.march_steps(rt["near"], rt["far"], 96, 2.0 / 96)
        xs = [o_n[:, None, a] + d_n[:, None, a] * t5 for a in range(3)]
        row, lane, _ = OM.grid_rows_lanes((64, 64, 64), *xs)
        row, lane = row.reshape(-1).contiguous(), lane.reshape(-1).contiguous()
        values = model.accel.occ.occ().reshape(4096, 64).to(torch.float32)
        n = row.numel()
        r = {"n": n, "table": list(values.shape)}
        plain = G.gather_rows_lanes_plain(values, row, lane)
        for m in ("b5_parent", *B5_EXACT):
            _same(r, f"{m}_bitwise_vs_plain",
                  _gather(libs[m], values, row, lane), plain)
        r["ms"] = _turns({m: (lambda m=m: _gather(libs[m], values, row, lane))
                          for m in B5_NAMES}, B5_NAMES + B5_NAMES[::-1])
        rl, ll = row.long(), lane.long()
        r["library_ms"] = [CS._time_ms(lambda: values[rl, ll])
                           for _ in range(2)]
        r["bound_ms"], r["bound_by"] = CS._bound(n * 12 + values.numel() * 4,
                                                 0)
        print(f"[B5 f4_render] {json.dumps(r)}")
        res = {"f4_render": r}
        # every tail length, misaligned views, clamped indices: bits
        rng = np.random.default_rng(60)
        rr = torch.from_numpy(rng.integers(-3, 4100, 393_218).astype(
            np.int32)).to(dev)
        cc = torch.from_numpy(rng.integers(-70, 140, 393_218).astype(
            np.int32)).to(dev)
        for k in (1, 2, 3, 5, 393_217):
            for m in ("b5_new", "b5_x4"):
                for how, sl in (("clamped", slice(0, k)),
                                ("misaligned", slice(1, k + 1))):
                    _same(res, f"{how}_n{k}_{m}_bitwise_vs_plain",
                          _gather(libs[m], values, rr[sl], cc[sl]),
                          G.gather_rows_lanes_plain(values, rr[sl], cc[sl]))
    return res


def _in_path(libs: dict, names: tuple, module, attr: str, call,
             kernel: str, run) -> dict:
    """The kernel's device time and the pass's inside `run()` (three passes
    under torch.profiler), with `module.attr` routed by `call(lib, ...)`
    to each of the two libraries `names` in turns; and whether the
    passes' outputs are the same bits under both."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    orig, out, outputs = getattr(module, attr), {}, {}

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


def _paths(libs: dict, dev, neus4, neus2, nerf) -> dict:
    """B3 inside the F=4 NeuS render and train step; B5 inside the F=4
    render, the F=2 NeuS render and the F=2 NeRF render."""
    import torch
    import chip_smoke as CS
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4
    from nr3d_lib_tpu_torch.ops import occgrid_march as OM

    o, d = _rays(dev, CS.N_RAYS)
    o8, d8 = _rays(dev, CS.N_RAYS_NERF)

    def render(model, oo, dd):
        def go():
            with torch.no_grad():
                rendered, _ = model.ray_query(CS._tested(model, oo, dd))
            return {k: v for k, v in rendered.items()
                    if isinstance(v, torch.Tensor)}
        return go

    def step(model):
        def go():
            g = torch.Generator(device=dev).manual_seed(9)
            model.training_before_per_step(1, g)
            with torch.enable_grad():
                loss = CS._step_loss(model, o, d, generator=g)
                loss.backward()
            model.zero_grad(set_to_none=True)
            return {"loss": loss.detach()}
        return go

    res = {}
    b3 = ("b3_parent", "b3_new")
    for key, names, module, attr, call, kernel, run in (
            ("b3_f4_render", b3, B4, "_dydx_cuda", _dydx, B3,
             render(neus4, o, d)),
            ("b3_f4_step", b3, B4, "_dydx_cuda", _dydx, B3, step(neus4)),
            ("b5_f4_render", B5_IN_PATH, OM, "gather_rows_lanes", _gather,
             B5, render(neus4, o, d)),
            ("b5_f2_render", B5_IN_PATH, OM, "gather_rows_lanes", _gather,
             B5, render(neus2, o, d)),
            ("b5_nerf_render", B5_IN_PATH, OM, "gather_rows_lanes", _gather,
             B5, render(nerf, o8, d8))):
        res[key] = _in_path(libs, names, module, attr, call, kernel, run)
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


def _main_bidx(parent: Path) -> int:
    """`--bidx`: the null-bidx B6, B7, B8 and B9 against the parent's
    brick.cu only."""
    import torch
    import chip_smoke as CS

    dev = torch.device("cuda")
    print(f"[device] {CS._smi()}")
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = {"b68_parent": (parent / B68F, parent),
               "b68_new": (NEW / B68F, NEW)}
    _nvcc_all(sources)
    libs = {n: _load(BUILD / f"lib{n}.so", src)
            for n, (src, _) in sources.items()}
    _, neus2, nerf = _models()
    res = {"b68_null_bidx_bitwise": _b68(libs, dev, neus2, nerf),
           "b79_null_bidx": _b79(libs, dev, neus2, nerf)}
    res["failed"] = _check(res)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


def main() -> int:
    import torch

    bidx = sys.argv[1:2] == ["--bidx"]
    args = sys.argv[2:] if bidx else sys.argv[1:]
    if len(args) != 1 or not Path(args[0], B3F).is_file():
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as CS

    if bidx:
        return _main_bidx(Path(args[0]).resolve())
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
                           if B3 in k or B5 in k}
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
    libs = {n: _load(p) for n, p in paths.items()}
    neus4, neus2, nerf = _models()
    res["b3"] = _b3(libs, dev, neus4)
    res["b5"] = _b5(libs, dev, neus4)
    res["paths"] = _paths(libs, dev, neus4, neus2, nerf)
    res["failed"] = _check(res)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
